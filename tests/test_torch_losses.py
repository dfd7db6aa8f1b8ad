"""Port parity for the loss stack on the CPU, against the JAX package:
every loss_type, with the code-logit masking and the histogram
weighting on and off, the negative-sentinel EMA on step 0 and a carried
EMA on step 1. Inputs from a seed with numpy, NHWC at 4x4, b2.

Tolerance: 1e-6, relative and absolute. The elementwise terms agree to
an ulp; the means are float32 reductions in another order, and XLA's on
the CPU drifts from the exact mean by ~1.5e-7 times the square root of
the element count (1.8e-6 over 12k elements, 4e-6 on a masked 2k),
so the inputs are kept at 512 code elements, where both stay inside
1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu.models import losses as jl
from zebrapose_tpu_torch.models import losses as tl

TOL = 1e-6


def _inputs(seed, n=2, h=4, w=4, bits=16, base=2, entire=True,
            ce=False):
    rng = np.random.default_rng(seed)
    head = bits * base if ce else bits
    out = {"mask": rng.normal(0, 2, (n, h, w, 1)).astype(np.float32),
           "code": rng.normal(0, 2, (n, h, w, head)).astype(np.float32)}
    if entire:
        out["entire_mask"] = rng.normal(0, 2, (n, h, w, 1)).astype(
            np.float32)
    gt = {"mask": (rng.random((n, h, w)) > 0.5).astype(np.float32),
          "entire_mask": (rng.random((n, h, w)) > 0.4).astype(np.float32),
          "code": rng.integers(0, base, (n, h, w, bits)).astype(np.float32)}
    return out, gt


def _both(fn_j, fn_t, *args):
    want = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in args])
    got = fn_t(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in args])
    return want, got


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


CONFIGS = [
    dict(loss_type="BCE"),
    dict(loss_type="BCE", use_histogram_weighting=False),
    dict(loss_type="BCE", mask_code_loss=False),
    dict(loss_type="BCE", mask_code_loss=False,
         use_histogram_weighting=False),
    dict(loss_type="L1"),
    dict(loss_type="L1", mask_code_loss=False,
         use_histogram_weighting=False),
    dict(loss_type="CE", base=2, use_histogram_weighting=False),
    dict(loss_type="CE", base=4, n_bits=8, mask_code_loss=False,
         use_histogram_weighting=False),
]


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_total_loss_matches_jax_over_two_steps(kw):
    """Step 0 from the sentinel histogram, step 1 from the carried EMA
    (another batch), with and without the entire-mask term."""
    jcfg = jl.CodeLossConfig(**kw)
    tcfg = tl.CodeLossConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    bits = tcfg.n_bits
    jh = jl.fresh_histogram(bits)
    th = tl.fresh_histogram(bits)
    _close(th, jh)
    for step, entire in ((0, True), (1, False)):
        out, gt = _inputs(10 + step, bits=bits, base=tcfg.base,
                          entire=entire, ce=tcfg.loss_type == "CE")
        gt_entire = gt["entire_mask"] if entire else None
        jl_, jh_new, jm = jl.total_loss(
            {k: jnp.asarray(v) for k, v in out.items()},
            jnp.asarray(gt["mask"]),
            None if gt_entire is None else jnp.asarray(gt_entire),
            jnp.asarray(gt["code"]), jh, jcfg, binary_loss_weight=3.0)
        tl_, th_new, tm = tl.total_loss(
            {k: torch.from_numpy(v) for k, v in out.items()},
            torch.from_numpy(gt["mask"]),
            None if gt_entire is None else torch.from_numpy(gt_entire),
            torch.from_numpy(gt["code"]), th, tcfg, binary_loss_weight=3.0)
        _close(tl_.item(), float(jl_))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            _close(tm[k].item(), float(jm[k]))
        _close(th_new.numpy(), np.asarray(jh_new))
        if tcfg.use_histogram_weighting:
            assert (th_new.numpy() >= 0).all()     # EMA initialized
        jh, th = jh_new, th_new


def test_histogram_ema_and_weights_match_jax():
    rng = np.random.default_rng(3)
    hist = rng.uniform(0, 0.6, 16).astype(np.float32)
    _close(*_both(jl.histogram_bin_weights, tl.histogram_bin_weights, hist))
    out, gt = _inputs(4)
    mask_hard = (out["mask"] > 0).astype(np.float32)
    (jm, jh), (tm, th) = _both(jl.hamming_histogram, tl.hamming_histogram,
                               out["code"], gt["code"], mask_hard)
    _close(tm, jm)
    _close(th, jh)
    # a carried EMA: 0.95 old + 0.05 new
    cfg = tl.CodeLossConfig()
    _, new, _ = tl.binary_code_loss(torch.from_numpy(out["code"]),
                                    torch.from_numpy(out["mask"]),
                                    torch.from_numpy(gt["code"]),
                                    torch.from_numpy(hist), cfg)
    _close(new.numpy(), 0.05 * th.numpy() + 0.95 * hist)


def test_elementwise_pieces_match_jax():
    out, gt = _inputs(5)
    _close(*_both(jl.sigmoid_l1_mask_loss, tl.sigmoid_l1_mask_loss,
                  out["mask"], gt["mask"]))
    want, got = _both(jl._bce_with_logits, tl._bce_with_logits,
                      out["code"], gt["code"])
    _close(got, want)
    w = np.random.default_rng(6).uniform(0.5, 2, 16).astype(np.float32)
    _close(*_both(jl.weighted_bce_per_bit, tl.weighted_bce_per_bit,
                  out["code"], gt["code"], w))


def test_loss_gradients_flow_through_the_code_logits_only_where_masked():
    """The hard mask is detached: the mask head gets gradient from the
    mask L1 term alone, and a masked-out pixel's code logits get none."""
    out, gt = _inputs(7, entire=False)
    code = torch.from_numpy(out["code"]).requires_grad_()
    mask = torch.from_numpy(out["mask"]).requires_grad_()
    loss, _, _ = tl.total_loss({"code": code, "mask": mask},
                               torch.from_numpy(gt["mask"]), None,
                               torch.from_numpy(gt["code"]),
                               tl.fresh_histogram(16), tl.CodeLossConfig())
    loss.backward()
    off = out["mask"][..., 0] <= 0
    assert float(code.grad[torch.from_numpy(off)].abs().max()) == 0.0
    assert float(code.grad[torch.from_numpy(~off)].abs().max()) > 0.0
    only_mask = torch.autograd.grad(
        tl.sigmoid_l1_mask_loss(mask, torch.from_numpy(gt["mask"])), mask)[0]
    np.testing.assert_allclose(mask.grad.numpy(), only_mask.numpy(),
                               atol=1e-7)
