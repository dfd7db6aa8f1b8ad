"""int8 through the eval program on the CPU: the port's int8 eval step
(`make_eval_step` over ZebraPoseNet(quant=True), the plain versions of
the int8 kernels) against the JAX package's, and the int8 serving
artifacts of one object and of a fleet against the live int8 steps.

Scene: tests/test_torch_serving.py's (v2 with flax-initialized weights,
the mask head's bias raised, 96x128 frames, 128² crops, 64² code maps),
with the LUT made from the JAX int8 network's own codes, so each crop
decodes to a real pose. Tolerances and why:
  * port vs JAX (JAX's keys given to the port as draws): the int8 layers
    are JAX's bit for bit on equal inputs, but float noise upstream
    moves a few quantized values (tests/test_torch_int8.py), so hard
    masks and codes are held to >= 99.5 % equal; verdicts (success)
    equal on every row; on rows whose hard outputs agree, poses to
    tests/test_torch_slice.py::_assert_poses, and on every solved row
    R within 0.1 degrees and t within 0.5 mm (other inlier sets of the
    same exact-geometry scene; the card's serving gates).
  * the artifacts vs the live int8 steps with the same draws: exact.
    A symbolic-batch artifact served one crop poses it as the live step
    does on that crop alone: ServingProgram pads with a copy of the
    row, so the activation scales are the crop's own (a zero row would
    enter the per-tensor max); verdicts and inlier counts equal, R and
    t to _assert_poses (the decode's batched float ops at two rows round
    differently from one, ~3e-8 in R).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_model import flax_variables
from test_torch_pnp import jax_ransac_draws
from test_torch_serving import (  # noqa: F401  (the fixture: autouse)
    BITS,
    KW,
    PNP,
    H,
    W,
    _call,
    _draws,
    _feed,
    _hide_module_stubs_from_fixtures,
    relief_lut,
)
from test_torch_slice import _assert_poses
from test_torch_trainer import _hide_module_stubs  # noqa: F401  (autouse)
from zebrapose_tpu.codec.lut import CorrespondenceLUT as JLUT
from zebrapose_tpu.data.pipeline import preprocess_batch as j_preprocess
from zebrapose_tpu.eval import evaluate as jev
from zebrapose_tpu.models.zebra_net import ZebraPoseNet as JNet
from zebrapose_tpu.ops import pnp as jpnp
from zebrapose_tpu.ops.binarize import code_from_logits as j_code
from zebrapose_tpu_torch.eval import export_serving as es
from zebrapose_tpu_torch.eval import fleet_serve as tfs
from zebrapose_tpu_torch.eval.evaluate import make_eval_step
from zebrapose_tpu_torch.models.convert import variables_to_state_dict
from zebrapose_tpu_torch.models.layers import quantized_convs
from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
from zebrapose_tpu_torch.ops.pnp import PnPConfig

N_QUANT = 37            # v2 / ResNet34 convs above the int8 gate


def _variables(rng):
    v = flax_variables("v2", rng)
    head = v["params"]["aspp"]["conv_1x1_4"]["conv"]
    head["bias"] = head["bias"].copy()
    head["bias"][0] = 20.0
    return v


def _jax_codes(variables, raw):
    jmodel = JNet(binary_code_length=BITS, variant="v2", quant=True)
    image = j_preprocess({k: jnp.asarray(v) for k, v in raw.items()},
                         jax.random.PRNGKey(0), crop_img=128, crop_gt=64,
                         is_train=False, include_gt=False)["image"]
    out = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, image)
    n = image.shape[0]
    ids = (np.asarray(j_code(out["code"])).reshape(n, -1, BITS)
           @ (2 ** np.arange(BITS - 1, -1, -1))).astype(np.int64)
    return jmodel, out, ids


def _int8_model(variables, dtype=torch.float32):
    model = ZebraPoseNet(binary_code_length=BITS, variant="v2",
                         quant=True).eval()
    model.load_state_dict(variables_to_state_dict(variables, "v2"))
    return model.to(dtype)


def _count(prog, name):
    """The program's calls of a zebrapose op, in its graph and in the
    graphs of its submodules (a no_grad region is one)."""
    target = getattr(torch.ops.zebrapose, name).default
    return sum(1 for m in prog.program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes if n.target is target)


def _jax_step(jmodel, lut):
    return jev.make_eval_step(
        lambda b, v: jmodel.apply(v, b["image"], train=False),
        JLUT(lut.points, lut.valid, 2, BITS), pnp_cfg=jpnp.PnPConfig(**PNP),
        preprocess_gt=False, return_masks=True, return_codes=True,
        use_kernel=False, **KW)


@pytest.fixture(scope="module")
def single():
    """The scene LUT is made from the codes of JAX's int8 eval step
    itself (a separate jit of the network may flip a few quantized
    values, see the module docstring)."""
    rng = np.random.default_rng(40)
    variables = _variables(rng)
    raw, fb, Ks = _feed(2, rng)
    jmodel, jout, ids = _jax_codes(variables, raw)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    codes = _jax_step(jmodel, relief_lut(ids, fb, rng))(
        jraw, jnp.asarray(fb), jnp.asarray(Ks), jax.random.PRNGKey(0),
        variables)[6]
    ids = (np.asarray(codes).reshape(2, -1, BITS)
           @ (2 ** np.arange(BITS - 1, -1, -1))).astype(np.int64)
    lut = relief_lut(ids, fb, rng)
    model = _int8_model(variables)
    live = make_eval_step(lambda b: model(b["image"]), lut,
                          pnp_cfg=PnPConfig(**PNP), preprocess_gt=False,
                          return_masks=True, return_codes=True,
                          device="cpu", **KW)
    return {"variables": variables, "jmodel": jmodel, "jout": jout,
            "lut": lut, "model": model, "live": live,
            "feed": (raw, fb, Ks)}


def test_int8_eval_step_matches_jax(single):
    raw, fb, Ks = single["feed"]
    jstep = _jax_step(single["jmodel"], single["lut"])
    key = jax.random.PRNGKey(7)
    want = jstep({k: jnp.asarray(v) for k, v in raw.items()},
                 jnp.asarray(fb), jnp.asarray(Ks), key, single["variables"])
    draws = jax_ransac_draws(jax.random.split(key, 2), 64 * 64,
                             PnPConfig(**PNP))
    got = single["live"](raw, fb, Ks, draws=draws)
    same = []
    for i in (4, 6):                    # visible masks, codes
        g, w = got[i].numpy(), np.asarray(want[i])
        agree = np.mean(g == w)
        print(f"output {i}: hard values equal on {agree:.5f}")
        assert agree >= 0.995
        same.append((g == w).reshape(2, -1).all(-1))
    ok = np.asarray(want[2])
    np.testing.assert_array_equal(got[2].numpy(), ok)      # verdicts
    assert ok.any()                             # a real pose is compared
    rows = same[0] & same[1] & ok
    if rows.any():
        _assert_poses(got[:4], want[:4], rows)
    # rows whose codes differ in a few pixels: the same pose from other
    # inlier sets (the card's serving gates: 0.1 degrees, 0.5 mm)
    R, Rj = got[0].numpy()[ok], np.asarray(want[0])[ok]
    ang = np.degrees(np.arccos(np.clip(
        (np.einsum("bij,bij->b", R, Rj) - 1) / 2, -1, 1)))
    dt = np.linalg.norm(got[1].numpy()[ok] - np.asarray(want[1])[ok], axis=1)
    print(f"solved rows: R {ang} degrees, t {dt} mm apart")
    assert ang.max() < 0.1 and dt.max() < 0.5


def test_int8_artifact_serves_the_live_step(single):
    """A symbolic-batch int8 artifact: one `quantize_act` and one
    `int8_conv2d` node per quantized conv, the live int8 step's outputs
    at a batch of two, and at a batch of one the live step on that crop
    alone."""
    module = es.build_serving_fn(single["model"], single["lut"],
                                 pnp_cfg=PnPConfig(**PNP), device="cpu",
                                 **KW)
    prog = es.load_serving(es.export_serving(module, None, (H, W),
                                             meta={"int8": True}), "cpu")
    assert prog.meta["int8"]
    assert len(quantized_convs(single["model"])) == N_QUANT
    assert _count(prog, "int8_conv2d") == _count(prog, "quantize_act") \
        == N_QUANT
    raw, fb, Ks = single["feed"]
    draws = _draws(2, 3)
    got = _call(prog, raw, fb, Ks, draws)
    want = single["live"](raw, fb, Ks, draws=draws)
    for g, w in zip(got, want[:4]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    for row in range(2):
        one = ({k: v[row:row + 1] for k, v in raw.items()},
               fb[row:row + 1], Ks[row:row + 1])
        d1 = _draws(1, 10 + row)
        _assert_poses(_call(prog, *one, d1),
                      single["live"](*one, draws=d1)[:4])


def test_int8_fleet_artifact_serves_the_live_step():
    """`export-serving-fleet --int8`'s module: K = 2 int8 members, one
    int8 node pair per quantized conv and member, the live fleet step
    (forwards in turn, as `test-fleet --int8` runs) at a batch of two and
    alone at a batch of one; a bf16 build keeps the quantized convs'
    stacked weights f32."""
    rng = np.random.default_rng(41)
    raw, fb, Ks = _feed(4, rng)                 # rows 0-1: ape, 2-3: cat
    variables = [_variables(rng) for _ in range(2)]
    luts = []
    for k, v in enumerate(variables):
        _, _, ids = _jax_codes(v, {n: a[2 * k:2 * k + 2]
                                   for n, a in raw.items()})
        luts.append(relief_lut(ids, fb[2 * k:2 * k + 2], rng))
    with torch.device("meta"):
        template = ZebraPoseNet(binary_code_length=BITS, quant=True).eval()
    keep = [n for n, _ in template.named_parameters()] + \
        [n for n, _ in template.named_buffers()]
    sds = [variables_to_state_dict(v, "v2") for v in variables]
    stacked = tfs.stack_variables([{n: sd[n] for n in keep} for sd in sds],
                                  "cpu")
    bf16 = es.build_fleet_serving_fn(template, stacked, luts,
                                     pnp_cfg=PnPConfig(**PNP), bf16=True,
                                     device="cpu", **KW)
    names = dict(bf16.named_buffers())
    for conv in quantized_convs(template):
        assert names[bf16._names[conv + ".weight"]].dtype == torch.float32
    assert names[bf16._names["net.resnet.resnet.0.weight"]].dtype == \
        torch.bfloat16

    module = es.build_fleet_serving_fn(template, stacked, luts,
                                       pnp_cfg=PnPConfig(**PNP),
                                       device="cpu", **KW)
    prog = es.load_serving(es.export_serving(module, None, (H, W)), "cpu")
    assert _count(prog, "int8_conv2d") == 2 * N_QUANT
    lp, lv = tfs.stack_luts(luts)
    live = tfs.make_fleet_eval_step(
        tfs.model_forward(template), lp, lv, pnp_cfg=PnPConfig(**PNP),
        vmap_forward=False, device="cpu", **KW)

    def call(rows, seeds):
        feed = ({k: v[rows] for k, v in raw.items()}, fb[rows], Ks[rows])
        draws = [_draws(len(rows) // 2, s) for s in seeds]
        got = prog(*prog.frame_args(*feed),
                   torch.stack([d.prio for d in draws]),
                   torch.stack([d.u for d in draws]))
        want = live(*feed, stacked, draws=draws)
        if len(rows) > 2:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w.numpy())
        else:
            for k in range(2):
                _assert_poses([g[k] for g in got], [w[k] for w in want])

    call([0, 1, 2, 3], (5, 6))
    call([1, 3], (7, 8))
