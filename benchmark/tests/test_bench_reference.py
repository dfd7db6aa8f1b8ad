"""The frozen reference matches the port at a tiny size on the CPU: the
v2 forward, an int8 convolution, the decode under the same draws, and a
train step."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness


def _nets(quant=False):
    from benchmark.reference.io import checkpoint_state_dict
    from zebrapose_tpu_torch.eval.runner import load_model_variables
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    cfg = harness.load_json(harness.BENCH / "configs" /
                            "zebrapose-v2-r34.json")
    ckpt = str(harness.ROOT / cfg["checkpoint"])
    port = ZebraPoseNet(16, 2, "v2", quant=quant)
    port.load_state_dict(load_model_variables(ckpt, "v2"), strict=True)
    ref = harness.reference_network(cfg, quant=quant)
    ref.load_state_dict(checkpoint_state_dict(ckpt), strict=True)
    return port.eval(), ref.eval()


def test_v2_forward_matches():
    port, ref = _nets()
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert set(a) == set(b) == {"mask", "entire_mask", "code"}
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-5)


def test_int8_conv_matches_the_ports_integer_arithmetic():
    from benchmark.reference.int8 import int8_conv2d, quantize_act
    from benchmark.reference.layers import quantize_weight
    from zebrapose_tpu_torch.models.layers import _int8_conv

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 32, 9, 11, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 32, 3, 3, generator=g)
    b = torch.randn(64, generator=g)
    for stride, pad, dil in ((1, 1, 1), (2, 1, 1), (1, 2, 2)):
        y_port = _int8_conv(x, w, b, stride, pad, dil)
        xq, sx = quantize_act(x.permute(0, 2, 3, 1))
        wq, sw = quantize_weight(w)
        y_ref = int8_conv2d(xq, wq.permute(0, 2, 3, 1), sx, sw, b, stride,
                            pad, dil, torch.bfloat16, exact=True)
        assert torch.equal(y_port, y_ref.permute(0, 3, 1, 2))


def test_int8_network_matches():
    port, ref = _nets(quant=True)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a, b = port(x), ref(x)
    for k in a:
        # the port's plain int8 sums are exact in float64, the reference's
        # forward sums in float32: a few codes can round the other way
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=2e-2)


def test_decode_with_the_same_draws_matches():
    from benchmark.reference import pnp as ref_pnp
    from benchmark.reference.io import load_lut
    from zebrapose_tpu_torch.ops import pnp

    pts, valid = (torch.from_numpy(a) for a in load_lut(
        str(harness.ROOT / "trained" / "rehearsal3_lut.npz")))
    g = torch.Generator().manual_seed(4)
    B, G = 3, 32
    masks = torch.zeros(B, G, G)
    masks[:, 8:24, 6:26] = 1.0
    ids = torch.nonzero(valid).reshape(-1)
    cls = ids[torch.randint(0, ids.numel(), (B, G, G), generator=g)]
    shifts = torch.arange(15, -1, -1)
    codes = ((cls[..., None] >> shifts) & 1).float()
    bbox = torch.tensor([[250, 180, 120, 120]] * B, dtype=torch.int32)
    K = torch.tensor(np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                                       [0, 0, 1]], np.float32), (B, 1, 1)))
    cfg = dict(max_points=256, n_hypotheses=32)
    n_pad = ref_pnp.subset_pad_len(G * G, ref_pnp.PnPConfig(**cfg))
    prio = torch.rand(B, n_pad, generator=g)
    u = torch.rand(B, 32, 5, generator=g)
    a = pnp.decode_to_pose_batch(masks, codes, pts, valid, bbox, K,
                                 bbox_size=G, cfg=pnp.PnPConfig(**cfg),
                                 draws=pnp.RansacDraws(prio=prio, u=u))
    b = ref_pnp.decode_to_pose_batch(masks, codes, pts, valid, bbox, K,
                                     bbox_size=G, cfg=ref_pnp.PnPConfig(**cfg),
                                     draws=ref_pnp.RansacDraws(prio=prio, u=u))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_train_step_matches_in_float32():
    from benchmark import checks
    from benchmark.drivers import train as drv
    from benchmark.tests.tiny import TRAIN_TINY, TinyCell

    cell = TinyCell("zebrapose-v2-r34.json", dict(TRAIN_TINY, batch=2))
    cell.config["train"]["bf16_autocast"] = False
    dev = torch.device("cpu")
    split = drv.Split(cell.config, cell.traffic, 7, dev)
    trainer = drv.Trainer(cell.config, cell.traffic, 7, dev, split)
    snap = trainer.checked_steps(2)
    num = checks.train_numbers(cell.config, cell.traffic, 7, split,
                               trainer.init, snap, dev)
    assert num["input_mismatch"] == 0 and num["batch_err"] == 0
    assert num["loss_gap_1"] < 1e-5
    assert num["grad_gap_median_leaf"] < 1e-4
    # after Adam's first update a few elements of near-zero gradient
    # step the other way, so a code bit may flip at a pixel or two
    assert num["hist_gap"] < 1e-3
