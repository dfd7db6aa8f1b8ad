"""Port parity for the training step on the CPU, against the JAX package:
BatchNorm's train-mode statistics, Adam with the StepLR schedule, one
and three `train_step`s of ZebraPoseNet v2 (32² crops, b2, flax
variables carried by `variables_to_state_dict`), gradient accumulation,
`eval_loss_step`, and the ImageNet backbone loader.

Tolerances and why:
  * BN: outputs and running statistics within 1e-5 (float32 moments of
    2k values a channel).
  * Adam + schedule: parameters within 1e-6 over 25 steps (the same
    formula; optax and torch round the bias corrections differently).
  * one step in float32: losses within 1e-4 relative, BN running
    statistics within 2e-5 (the deepest activations agree to the
    forward's 2e-4 of test_torch_model, and an update takes a tenth of
    the batch moments), histogram within 1e-5 (the same pixels counted;
    a code logit within 1e-5 of 0 could flip one, none does here).
  * gradients: each tensor within 1e-4 relative L2, grad_norm within
    1e-6 and the BN running statistics within 1e-5 after one step, then
    three steps' losses and grad_norm within 1e-4 relative,
    with the network in float64 on both sides (see the test for why not
    float32). JAX's gradient is read from its Adam state after one
    update: mu = 0.1 * g.
"""

import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_model import flax_variables
from zebrapose_tpu.models import layers as jlayers
from zebrapose_tpu.models.convert_torch import (
    convert_torchvision_resnet34,
    merge_pretrained,
)
from zebrapose_tpu.models.losses import CodeLossConfig as JLossCfg
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.train import state as jstate
from zebrapose_tpu.train import train_step as jts
from zebrapose_tpu_torch.models.convert import (
    load_torchvision_resnet34,
    variables_to_state_dict,
)
from zebrapose_tpu_torch.models.layers import TorchBatchNorm
from zebrapose_tpu_torch.models.losses import CodeLossConfig
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.train import train_step as tts
from zebrapose_tpu_torch.train.state import (
    create_train_state,
    make_lr_schedule,
)

LR = 2e-4


@pytest.fixture(autouse=True)
def _hide_module_stubs():
    """Under xdist every worker imports
    tests/test_real_reference_module.py, whose stub `imgaug` modules
    answer every attribute, `__file__` included. The first torch
    optimizer imports torch._dynamo, which walks sys.modules with
    `inspect` and trips on them; hide them while a test runs."""
    stubs = {k: sys.modules.pop(k) for k in ("imgaug", "imgaug.augmenters")
             if k in sys.modules}
    yield
    sys.modules.update(stubs)


def _batch(seed, n=2, img=32, out=16, bits=16):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
        "mask": (rng.random((n, out, out)) > 0.5).astype(np.float32),
        "entire_mask": (rng.random((n, out, out)) > 0.3).astype(np.float32),
        "code": (rng.random((n, out, out, bits)) > 0.5).astype(np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


class _JBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train):
        return jlayers.TorchBatchNorm()(x, train)


def test_batchnorm_train_statistics_match_flax():
    """flax moves running_var toward the biased batch variance; the
    port's TorchBatchNorm does too (torch's own update is n/(n-1)
    larger). Eval mode stays nn.BatchNorm2d's."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (4, 6, 5, 3)).astype(np.float32)   # NHWC
    mean0 = rng.normal(0, 0.5, 3).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, 3).astype(np.float32)
    bias = rng.normal(0, 0.1, 3).astype(np.float32)
    variables = {"params": {"TorchBatchNorm_0": {"bn": {
        "scale": scale, "bias": bias}}},
        "batch_stats": {"TorchBatchNorm_0": {"bn": {
            "mean": mean0, "var": var0}}}}
    want, mut = _JBN().apply(variables, jnp.asarray(x), True,
                             mutable=["batch_stats"])
    stats = mut["batch_stats"]["TorchBatchNorm_0"]["bn"]

    bn = TorchBatchNorm(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    stock = copy.deepcopy(torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.1))
    stock.load_state_dict(bn.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = bn.train()(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)
    # the finding: torch's stock update misses flax's by the n/(n-1) term
    stock.train()(xt)
    assert np.abs(stock.running_var.numpy()
                  - np.asarray(stats["var"])).max() > 1e-3
    # eval mode: the running statistics, as nn.BatchNorm2d
    stock.load_state_dict(bn.state_dict())
    np.testing.assert_array_equal(bn.eval()(xt).detach().numpy(),
                                  stock.eval()(xt).detach().numpy())


def test_adam_and_schedule_match_optax_over_a_gamma_boundary():
    """torch.optim.Adam with the lr set from make_lr_schedule before each
    update against optax.adam(make_lr_schedule(...)), on injected
    gradients, 25 steps across two decays (period 10)."""
    rng = np.random.default_rng(1)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 10 ** rng.uniform(-4, 1), s).astype(np.float32)
              for s in shapes] for _ in range(25)]
    jsched = jstate.make_lr_schedule(1e-2, gamma=0.5, log_freq=1)
    tsched = make_lr_schedule(1e-2, gamma=0.5, log_freq=1)
    assert [tsched(s) for s in (0, 9, 10, 19, 20, 24)] == \
        [1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3, 2.5e-3]
    for s in (0, 9, 10, 21):
        np.testing.assert_allclose(float(jsched(s)), tsched(s), rtol=1e-7)

    tx = optax.adam(jsched)
    jp = [jnp.asarray(p) for p in p0]
    opt = tx.init(jp)
    model = torch.nn.Module()
    model.ps = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0])
    state = create_train_state(model, 1e-2, gamma=0.5, log_freq=1)
    for g in grads:
        upd, opt = tx.update([jnp.asarray(x) for x in g], opt, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(model.ps, g):
            p.grad = torch.from_numpy(x.copy())
        tts.apply_accumulated(state, 1)
    assert state.step == 25
    for a, b in zip(model.ps, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def carried():
    """flax ZebraPoseNet v2 variables (BN statistics randomized) and the
    same weights in the port's model."""
    variables = flax_variables("v2", np.random.default_rng(2))
    return variables


def _port_state(variables, lr=LR):
    model = ZebraPoseNet(binary_code_length=16, variant="v2")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return create_train_state(model, lr, n_bits=16)


def _jax_state(variables, lr=LR):
    model = JNet(binary_code_length=16, variant="v2")
    return jstate.create_train_state(
        model, jax.tree.map(jnp.asarray, variables), learning_rate=lr,
        n_bits=16)


def _bn_stats(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _grads_in_port_names(js, divide=0.1):
    """JAX's gradient of its first update, read from its Adam state (mu =
    0.1 g), under the port's parameter names."""
    return variables_to_state_dict(
        {"params": jax.tree.map(lambda m: np.asarray(m) / divide,
                                js.opt_state[0].mu),
         "batch_stats": jax.tree.map(np.asarray, js.batch_stats)})


def test_one_train_step_matches_jax(carried):
    """float32, as training runs: the losses, the BN running statistics
    and the histogram after one step."""
    cfg_j, cfg_t = JLossCfg(), CodeLossConfig()
    batch = _batch(3)
    js, jm = jts.train_step(_jax_state(carried),
                            jax.tree.map(jnp.asarray, batch), cfg_j)
    ts = _port_state(carried)
    tm = tts.train_step(ts, _t(batch), cfg_t)
    assert sorted(tm) == sorted(jm)
    for k in ("loss_total", "loss_code", "loss_mask", "loss_entire_mask",
              "hamming"):
        assert _rel(tm[k].item(), float(jm[k])) < 1e-4, k
    want_stats = {k: v.numpy() for k, v in variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, js.params),
         "batch_stats": jax.tree.map(np.asarray, js.batch_stats)}).items()
        if k.endswith(("running_mean", "running_var"))}
    got_stats = _bn_stats(ts.model)
    assert sorted(got_stats) == sorted(want_stats)
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], atol=2e-5,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(ts.histogram.numpy(),
                               np.asarray(js.histogram), atol=1e-5)
    assert ts.step == int(js.step) == 1


def test_train_steps_match_jax_in_float64(carried):
    """The gradients of one step, tensor by tensor, and grad_norm; then
    two more steps on the same batch: losses and grad_norm. Both stacks
    run the network in float64 (the losses stay float32 in both). In
    float32 this network's train-mode gradient at b2 moves by ~1% per
    tensor with the order of float operations alone (the port's float32
    gradient is as far from its float64 one as from JAX's): ReLU masks
    and BN over few values turn rounding into discrete changes. In
    float64 the stacks agree to ~1e-8."""
    cfg_j, cfg_t = JLossCfg(), CodeLossConfig()
    batch = _batch(3)
    ts = _port_state(carried)
    ts.model.double()
    tb = {k: v.double() for k, v in _t(batch).items()}
    ts.optimizer.zero_grad(set_to_none=True)
    tm = tts.grad_step(ts, tb, cfg_t)
    grads = {n: p.grad.clone() for n, p in ts.model.named_parameters()}
    tm["grad_norm"] = tts.apply_accumulated(ts, 1)
    with jax.enable_x64(True):
        js = jstate.create_train_state(
            JNet(binary_code_length=16, variant="v2", dtype=jnp.float64),
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), carried),
            learning_rate=LR, n_bits=16)
        jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), batch)
        js, jm = jts.train_step(js, jb, cfg_j)
        jgrads = _grads_in_port_names(js)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert _rel(tm[k].item(), float(jm[k])) < 1e-6, k
        # the convolution biases a BatchNorm follows have gradient 0 in
        # exact arithmetic (~1e-18 here): relative to the whole gradient
        floor = 1e-6 * float(tm["grad_norm"])
        assert set(grads) <= set(jgrads)
        for name, g in grads.items():
            want = jgrads[name].numpy()
            rel = float(np.linalg.norm(g.numpy() - want)
                        / max(np.linalg.norm(want), floor))
            assert rel < 1e-4, (name, rel)
        got_stats = _bn_stats(ts.model)
        for k, v in jgrads.items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got_stats[k], v.numpy(),
                                           atol=1e-5, rtol=0, err_msg=k)
        for _ in range(2):
            js, jm = jts.train_step(js, jb, cfg_j)
            tm = tts.train_step(ts, tb, cfg_t)
            for k in ("loss_total", "loss_code", "loss_mask", "grad_norm"):
                assert _rel(tm[k].item(), float(jm[k])) < 1e-4, k
    assert ts.step == int(js.step) == 3


def test_accumulation_with_one_micro_batch_is_train_step(carried):
    """accum_train_step(k=1) = train_step; with k=2 the update uses the
    mean of the two micro-gradients at frozen parameters, and the BN
    statistics and histogram advance micro-batch by micro-batch."""
    cfg = CodeLossConfig()
    b1, b2 = _t(_batch(4)), _t(_batch(5))
    a, b = _port_state(carried), _port_state(carried)
    ma = tts.train_step(a, b1, cfg)
    mb = tts.accum_train_step(b, [b1], cfg)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for (n, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(p, q), n
    assert torch.equal(a.histogram, b.histogram)

    c, d = _port_state(carried), _port_state(carried)
    m2 = tts.accum_train_step(c, [b1, b2], cfg)
    # the same by hand: gradients of each micro-batch at the same weights
    d.optimizer.zero_grad(set_to_none=True)
    m_1 = tts.grad_step(d, b1, cfg)
    m_2 = tts.grad_step(d, b2, cfg)
    gn = tts.apply_accumulated(d, 2)
    assert torch.equal(m2["grad_norm"], gn)
    assert torch.equal(m2["loss_total"],
                       (m_1["loss_total"] + m_2["loss_total"]) / 2)
    for (n, p), q in zip(c.model.state_dict().items(),
                         d.model.state_dict().values()):
        assert torch.equal(p, q), n
    assert c.step == d.step == 1


def test_eval_loss_step_matches_jax(carried):
    cfg_j, cfg_t = JLossCfg(), CodeLossConfig()
    batch = _batch(6)
    js = _jax_state(carried)
    ts = _port_state(carried)
    hist = np.random.default_rng(7).uniform(0, 0.5, 16).astype(np.float32)
    js = js.replace(histogram=jnp.asarray(hist))
    ts.histogram = torch.from_numpy(hist)
    want = jts.eval_loss_step(js, jax.tree.map(jnp.asarray, batch), cfg_j)
    before = _bn_stats(ts.model)
    got = tts.eval_loss_step(ts, _t(batch), cfg_t)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k].item(), float(want[k])) < 1e-4, k
    # eval mode: no statistic moved, the histogram is read only, and the
    # model is back in train mode
    for k, v in _bn_stats(ts.model).items():
        np.testing.assert_array_equal(v, before[k])
    np.testing.assert_array_equal(ts.histogram.numpy(), hist)
    assert ts.model.training


def test_torchvision_backbone_loads_as_jax_merges_it():
    """load_torchvision_resnet34 on a synthesized torchvision resnet34
    state dict = JAX's convert_torchvision_resnet34 + merge_pretrained,
    carried by variables_to_state_dict; the rest keeps its init."""
    rng = np.random.default_rng(8)
    variables = flax_variables("v2", rng)
    model = ZebraPoseNet(binary_code_length=16, variant="v2")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    # torchvision's resnet34 keys for the stem, layer1 and layer2 (and a
    # few it has beyond them, which neither loader reads)
    shapes = {"conv1.weight": (64, 3, 7, 7)}
    for bn, c in (("bn1", 64),):
        shapes.update({f"{bn}.{k}": (c,) for k in (
            "weight", "bias", "running_mean", "running_var")})
    for layer, n, cin, c in (("layer1", 3, 64, 64), ("layer2", 4, 64, 128)):
        for i in range(n):
            pre = f"{layer}.{i}."
            shapes[pre + "conv1.weight"] = (c, cin if i == 0 else c, 3, 3)
            shapes[pre + "conv2.weight"] = (c, c, 3, 3)
            bns = ["bn1", "bn2"]
            if i == 0 and cin != c:
                shapes[pre + "downsample.0.weight"] = (c, cin, 1, 1)
                bns.append("downsample.1")
            for bn in bns:
                shapes.update({f"{pre}{bn}.{k}": (c,) for k in (
                    "weight", "bias", "running_mean", "running_var")})
    sd = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for k, s in shapes.items()}
    sd["layer3.0.conv1.weight"] = torch.zeros(256, 128, 3, 3)
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["bn1.num_batches_tracked"] = torch.tensor(7)

    load_torchvision_resnet34(model, sd)
    want = variables_to_state_dict(merge_pretrained(
        variables, convert_torchvision_resnet34(
            {k: v.numpy() for k, v in sd.items()})))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    # the skip-tap aliases follow the loaded modules
    assert torch.equal(got["net.resnet.resnet_layer_1.0.weight"],
                       sd["conv1.weight"])
    bad = dict(sd, **{"conv1.weight": torch.zeros(64, 3, 3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_torchvision_resnet34(model, bad)
    del bad["conv1.weight"]
    with pytest.raises(KeyError, match="conv1.weight"):
        load_torchvision_resnet34(model, bad)
