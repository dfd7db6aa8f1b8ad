"""The port's int8 serving convs (`models/layers.py::TorchConv(quant=
True)`, the plain versions of `ops/int8_conv.py`) against the JAX
package's `_Int8Conv`, on the CPU.

Inputs come from numpy seeds and go to both. Tolerances and why:
  * one conv: the int8 weights, their scales, the int8 activation, its
    scale and the int32 accumulator are equal (assert_array_equal); the
    output is within 1 f32 ulp of JAX's (both round acc -> f32, times
    sx·sw, plus b in f32; a fused multiply-add on either side would move
    the last bit).
  * below the Cin·Cout gate the conv is the float conv, bit for bit.
  * the whole v2 network at 64² in f32 with carried weights: each of
    its quantized convs, fed the input JAX's network gives it, returns
    JAX's output within 1 f32 ulp (QAT: 1e-5 of its scale). End to end,
    float differences of ~1e-6 in earlier layers move a few values
    across a rounding boundary of a later quantizer, and the change
    spreads; the logits are held to JAX's own sensitivity to an input
    perturbation of that size (test_network_matches_jax) and the hard
    bits (mask, code) to >= 99.5% agreement.
The int8 kernels themselves (CUDA) are held to these plain versions bit
for bit on the card by chip_smoke.py's phase 14.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_model import flax_variables
from zebrapose_tpu.models.layers import TorchConv as JConv
from zebrapose_tpu.models.layers import _FakeQuantConv as JFakeQuant
from zebrapose_tpu.models.layers import _Int8Conv as JInt8
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.layers import (
    TorchConv,
    cast_variables,
    quantize_weight,
    quantized_convs,
)
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops import int8_conv

# (k, stride, dilation, padding, cin, cout, bias, spatial)
CASES = {
    "1x1": (1, 1, 1, 0, 128, 256, True, 9),
    "3x3_dilation6": (3, 1, 6, 6, 64, 256, False, 12),
    "3x3_stride2": (3, 2, 1, 1, 128, 128, False, 11),
    "cin40": (3, 1, 2, 2, 40, 512, True, 7),
}


def _jax_int8_parts(kernel, bias, x, k, stride, dil, pad):
    """The steps of zebrapose_tpu/models/layers.py::_Int8Conv (lines
    49-66), in its order: (wq, sw, xq, sx, acc, y)."""
    w = kernel.astype(jnp.float32)
    sw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-8) / 127.0
    wq = jnp.round(w / sw).astype(jnp.int8)
    xf = x.astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, wq, window_strides=(stride, stride),
        padding=((pad, pad), (pad, pad)), rhs_dilation=(dil, dil),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * (sx * sw)
    if bias is not None:
        y = y + bias
    return [np.asarray(a) for a in (wq, sw, xq, sx, acc, y)]


def _ulps(a, b):
    """|a - b| in units of the last place of float32, elementwise."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_conv_matches_jax(case):
    k, stride, dil, pad, cin, cout, use_bias, hw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = rng.normal(size=(2, hw, hw, cin)).astype(np.float32)
    jconv = JConv(cout, k, stride, pad, dil, use_bias=use_bias, quant=True)
    variables = jax.tree.map(np.asarray, jconv.init(
        jax.random.PRNGKey(3), jnp.asarray(x)))
    params = variables["params"]["conv"]
    kernel = params["kernel"]
    bias = rng.normal(0, 0.1, cout).astype(np.float32) if use_bias else None
    if use_bias:
        params["bias"] = bias
    want_y = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    wq, sw, xq, sx, acc, y = _jax_int8_parts(
        jnp.asarray(kernel), None if bias is None else jnp.asarray(bias),
        jnp.asarray(x), k, stride, dil, pad)
    np.testing.assert_array_equal(y, want_y)     # the steps are JAX's

    conv = TorchConv(cin, cout, k, stride, pad, dil, use_bias=use_bias,
                     quant=True)
    assert conv.quant is True
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        if use_bias:
            conv.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x)
    got_wq, got_sw = quantize_weight(conv.weight.detach())
    np.testing.assert_array_equal(got_sw.numpy(), sw)
    np.testing.assert_array_equal(
        got_wq.to(torch.int8).permute(2, 3, 1, 0).numpy(), wq)
    got_xq, got_sx = int8_conv.quantize_act(xt)
    np.testing.assert_array_equal(got_sx.numpy(), np.reshape(sx, (1,)))
    np.testing.assert_array_equal(got_xq.numpy(), xq)
    wq_t = got_wq.to(torch.int8).permute(0, 2, 3, 1).contiguous()
    got_acc = int8_conv.int8_accumulate(got_xq, wq_t, stride, pad, dil)
    np.testing.assert_array_equal(got_acc.permute(0, 2, 3, 1).numpy(), acc)

    with torch.no_grad():
        got_y = conv(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    ulps = _ulps(got_y, want_y)
    print(f"{case}: max {ulps.max()} ulp, {int((ulps > 0).sum())} of "
          f"{ulps.size} outputs differ")
    assert ulps.max() <= 1


def test_int8_ops_shapes_and_zero_input():
    """The ops' CPU implementations (the plain versions) and their Meta
    shapes; an all-zero activation takes its scale from the 1e-8
    floor and quantizes to zeros."""
    x = torch.zeros(1, 5, 5, 48)
    xq, sx = int8_conv.quantize_act(x)
    assert sx.dtype == torch.float32 and sx.shape == (1,)
    assert sx.item() == np.float32(np.float32(1e-8) / np.float32(127.0))
    assert xq.dtype == torch.int8 and not xq.any()
    wq = torch.ones(16, 3, 3, 48, dtype=torch.int8)
    sw = torch.full((16,), 0.5)
    for dtype in (torch.float32, torch.bfloat16):
        y = int8_conv.int8_conv2d(xq, wq, sx, sw, None, 2, 18, 18, dtype)
        assert y.dtype == dtype and not y.any()
        meta = torch.ops.zebrapose.int8_conv2d(
            xq.to("meta"), wq.to("meta"), sx.to("meta"), sw.to("meta"),
            None, 2, 18, 18, dtype)
        assert meta.shape == y.shape == (1, 3, 3, 16)
    assert int8_conv.out_size(32, 3, 1, 18, 18) == 32
    with pytest.raises(ValueError, match="channels"):
        int8_conv.int8_conv2d(xq, wq[..., :8], sx, sw, None, 1, 1, 1,
                              torch.float32)


def test_small_convs_exempt_bit_exact():
    """Below Cin·Cout = 16384 a quantized TorchConv is the float conv,
    bit for bit (tests/test_int8.py::test_small_convs_exempt_bit_exact
    for JAX), in both quant modes; at the gate it quantizes."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 4, 16, 16)).astype(np.float32))
    plain = TorchConv(4, 8, 3, 1, 1)
    for quant in (True, "qat"):
        conv = TorchConv(4, 8, 3, 1, 1, quant=quant)
        conv.load_state_dict(plain.state_dict())
        assert conv.quant is False
        with torch.no_grad():
            np.testing.assert_array_equal(conv(x).numpy(), plain(x).numpy())
        assert TorchConv(128, 128, 1, quant=quant).quant == quant
        assert TorchConv(64, 128, 1, quant=quant).quant is False


def test_state_dict_loads_strictly_into_every_quant_mode():
    """The carried flax variables strict-load into quant=False, True and
    "qat" (no new keys: an int8 cache would be a non-persistent
    buffer), and a cast to bf16 keeps the quantized convs' f32
    parameters (the JAX layers quantize f32 params whatever the dtype)."""
    rng = np.random.default_rng(5)
    sd = variables_to_state_dict(flax_variables("v2", rng), "v2")
    for quant in (False, True, "qat"):
        model = ZebraPoseNet(binary_code_length=16, variant="v2",
                             quant=quant)
        model.load_state_dict(sd, strict=True)
        assert set(model.state_dict()) == set(sd)
    cast = model.to(torch.bfloat16)
    for name, conv in quantized_convs(cast).items():
        assert conv.weight.dtype == torch.float32, name
        assert torch.equal(conv.weight, sd[name + ".weight"]), name
    assert cast.net.resnet.resnet[0].weight.dtype == torch.bfloat16


@pytest.mark.parametrize("quant", [False, True, "qat"])
def test_cast_variables_follows_model_cast(quant):
    """cast_variables (the fleet artifact's cast of the stacked state)
    gives each tensor the dtype model.to(bf16) gives it: the quantized
    convs' parameters stay f32 and hold their values, the rest is
    bf16, the integer counters stay as they are."""
    rng = np.random.default_rng(6)
    sd = variables_to_state_dict(flax_variables("v2", rng), "v2")
    model = ZebraPoseNet(binary_code_length=16, variant="v2", quant=quant)
    model.load_state_dict(sd, strict=True)
    stacked = {n: torch.stack([v, v]) for n, v in model.state_dict().items()}
    got = cast_variables(model, stacked, torch.bfloat16)
    want = model.to(torch.bfloat16).state_dict()
    assert set(got) == set(want)
    for n, v in got.items():
        assert v.dtype == want[n].dtype, n
        assert torch.equal(v[1], want[n]), n
    f32 = {n for n, v in got.items() if v.dtype == torch.float32}
    convs = {n + "." + p for n in quantized_convs(model)
             for p in ("weight", "bias")}
    assert (convs & set(got)) <= f32
    assert bool(f32) == (quant is not False)


def test_quantized_conv_count():
    """The convs above the gate, by family: 37 for v2 / v1 on ResNet34
    (layer2 7, layer4 13, layer5 7, ASPP 6, each UpsampleBlock 2), which
    is how many times an int8 forward launches each int8 kernel."""
    counts = {}
    for name, kw in (("v2", {}), ("v1", {"variant": "v1"}),
                     ("v3", {"variant": "v3"}),
                     ("r50", {"resnet_layers": 50}),
                     ("base4", {"base": 4, "binary_code_length": 8})):
        with torch.device("meta"):
            model = ZebraPoseNet(quant=True, **{"variant": "v2", **kw})
        counts[name] = len(quantized_convs(model))
    print(counts)
    assert counts == {"v2": 37, "v1": 37, "v3": 46, "r50": 49, "base4": 37}
    with torch.device("meta"):
        names = quantized_convs(ZebraPoseNet(quant=True))
    stages = [n.split(".")[3] if n.startswith("net.resnet.resnet.")
              else n.split(".")[2 if n.startswith("net.resnet.") else 1]
              for n in names]
    assert {s: stages.count(s) for s in set(stages)} == {
        "5": 7, "layer4": 13, "layer5": 7, "aspp": 10}


def _network_runs(quant, variant="v2", **net_kw):
    """JAX's outputs (quantized, float, and quantized on the input
    scaled by 1 + 1e-6·noise for three noise seeds) and the port's
    quantized outputs, on carried weights at 64² in f32."""
    rng = np.random.default_rng(21)
    variables = flax_variables(variant, rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    xs = [x] + [(x * (1 + 1e-6 * np.random.default_rng(100 + s)
                      .standard_normal(x.shape))).astype(np.float32)
                for s in range(3)]
    jax_out = {}
    for q in (False, quant):
        jnet = JNet(binary_code_length=16, variant=variant, quant=q,
                    **net_kw)
        fn = jax.jit(lambda v, a: jnet.apply(v, a, train=False))
        jax_out[q] = [{k: np.asarray(v) for k, v in fn(
            variables, jnp.asarray(a)).items()}
            for a in (xs if q else x[None])]
    model = ZebraPoseNet(binary_code_length=16, variant=variant,
                         quant=quant, **net_kw).eval()
    model.load_state_dict(variables_to_state_dict(variables, variant),
                          strict=True)
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model(torch.from_numpy(x)).items()}
    return jax_out[quant], jax_out[False][0], got


def _layer_calls(variables, x, quant):
    """Every quantized conv of v2 in call order, on x: JAX's (input,
    output) pairs, and the port's conv modules."""
    impl = JFakeQuant if quant == "qat" else JInt8
    jax_calls = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, impl) and \
                context.method_name == "__call__":
            jax_calls.append((np.asarray(args[0]), np.asarray(out)))
        return out

    jnet = JNet(binary_code_length=16, variant="v2", quant=quant)
    with fnn.intercept_methods(record):
        jnet.apply(variables, jnp.asarray(x), train=False)
    model = ZebraPoseNet(binary_code_length=16, variant="v2",
                         quant=quant).eval()
    model.load_state_dict(variables_to_state_dict(variables, "v2"),
                          strict=True)
    port_calls = []
    hooks = [c.register_forward_hook(
        lambda mod, inp, out: port_calls.append(mod))
        for c in quantized_convs(model).values()]
    with torch.no_grad():
        model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    return jax_calls, port_calls


@pytest.mark.parametrize("quant", [True, "qat"])
def test_network_matches_jax(quant):
    """v2 at 64², f32, carried weights: the port's int8 (or QAT) network
    against JAX's.

    Layer by layer: each quantized conv of the port, fed the input JAX's
    network gives the same conv, returns JAX's output within 1 f32 ulp
    (QAT: 1e-5 of its largest value, as test_torch_qat.py holds the
    layer). A network that did not quantize is off there by the
    quantization error itself, far more than that.

    End to end the network is not smooth: the float layers' ~1e-6
    relative differences between the stacks (test_torch_model.py) move a
    few activations across a rounding boundary of the next quantizer,
    and the change spreads through the later layers. JAX's own output
    moves as much when its input is scaled by 1 + 1e-6·noise, and that
    move is as large as JAX's own int8-vs-float gap, so no end-to-end
    bound tells a float network apart (the layer check does). The
    end-to-end yardstick is that self-sensitivity: the port's max and
    mean |port - jax| within 1.5x JAX's largest over three such inputs,
    and the hard bits (mask, code) equal on >= 99.5% of pixels."""
    rng = np.random.default_rng(21)
    variables = flax_variables("v2", rng)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    jax_calls, port_calls = _layer_calls(variables, x, quant)
    assert len(jax_calls) == len(port_calls) == 37
    worst = 0.0
    for (xj, yj), conv in zip(jax_calls, port_calls):
        assert xj.shape[-1] == conv.in_channels
        with torch.no_grad():
            xt = torch.from_numpy(xj.copy()).permute(0, 3, 1, 2)
            y = conv(xt).permute(0, 2, 3, 1).numpy()
        assert y.shape == yj.shape
        if quant == "qat":
            err = np.abs(y - yj).max() / np.abs(yj).max()
            assert err <= 1e-5, (conv, err)
        else:
            err = _ulps(y, yj).max()
            assert err <= 1, (conv, err)
        worst = max(worst, float(err))
    print(f"quant={quant}: {len(jax_calls)} quantized convs on JAX's inputs, "
          f"worst {worst:.3g} " + ("relative" if quant == "qat" else "ulp"))

    runs, want_float, got = _network_runs(quant)
    want = runs[0]
    assert set(got) == set(want)
    for name in want:
        err = np.abs(got[name] - want[name])
        self_gap = [np.abs(r[name] - want[name]) for r in runs[1:]]
        self_max = max(g.max() for g in self_gap)
        self_mean = max(g.mean() for g in self_gap)
        gap = np.abs(want[name] - want_float[name])
        bits = np.mean((got[name] > 0) == (want[name] > 0))
        print(f"quant={quant} {name}: |port - jax| max {err.max():.4g} "
              f"mean {err.mean():.4g}; jax self-sensitivity max "
              f"{self_max:.4g} mean {self_mean:.4g}; jax int8 vs float "
              f"max {gap.max():.4g} mean {gap.mean():.4g}; hard bits equal "
              f"{bits:.5f}")
        assert err.max() <= 1.5 * self_max, (name, err.max(), self_max)
        assert err.mean() <= 1.5 * self_mean, (name, err.mean(), self_mean)
        assert bits >= 0.995, (name, bits)


@pytest.mark.parametrize("net_kw", [
    {"variant": "v1"}, {"variant": "v3"}, {"resnet_layers": 50},
    {"base": 4, "binary_code_length": 8}], ids=["v1", "v3", "r50", "base4"])
def test_other_families_run_in_int8(net_kw):
    """Every family's int8 forward runs and stays finite
    (tests/test_int8.py:190-201 for JAX); ResNet50's quantized convs
    include the Bottleneck's stride 2, v3's the 1025-channel fuse."""
    torch.manual_seed(0)
    model = ZebraPoseNet(quant=True, **{"variant": "v2", **net_kw}).eval()
    with torch.no_grad():
        out = model(torch.randn(1, 32, 32, 3))
    assert all(torch.isfinite(v).all() for v in out.values())
