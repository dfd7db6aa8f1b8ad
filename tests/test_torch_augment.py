"""Port parity for the GDR-Net augmentation and the training branch of
`preprocess_batch` on the CPU, against the JAX package.

JAX's draws are injected: `jax_augment_draws` consumes the JAX keys in
the order `zebrapose_tpu/ops/augment.py` does (split(key, n + 1): the
0.8 gate from the first key; each sample's key split 18 ways, every
enabled op taking its gate key, then its op key; disabled ops take no
key) and fills the port's `AugmentDraws` with the values JAX draws.

Tolerance: 1e-4 absolute on [0, 255] images (float32): each op, and
the recipe without motion blur. The Gaussian blur sums its taps in
JAX's order and agrees exactly; the motion blur is a convolution in
XLA, whose order of terms the port does not reproduce (2 ulps at 255,
3.1e-5). The ops after it scale that difference by at most 1.4 * 1.4 *
2 (the two multiplies and the contrast), so the recipe with motion blur
is held within MOTION_TOL = 4 * TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from zebrapose_tpu.data.pipeline import preprocess_batch as j_preprocess
from zebrapose_tpu.ops import augment as ja
from zebrapose_tpu_torch.data.pipeline import preprocess_batch
from zebrapose_tpu_torch.ops import augment as ta

TOL = 1e-4
MOTION_TOL = 4 * TOL


def jax_augment_draws(key, n, h, w, use_pepper_salt=False,
                      use_motion_blur=False):
    """The port's AugmentDraws holding what jax's augment_batch(images,
    key, ...) draws for a batch of n [h, w] crops."""
    keys = jax.random.split(key, n + 1)
    sample = np.asarray(jax.random.uniform(keys[0], (n,)) < 0.8)
    ops = (["pepper"] if use_pepper_salt else []) + \
        (["motion"] if use_motion_blur else []) + list(ta._OPS)
    apply = {op: [] for op in ops}
    vals = {k: [] for k in ("hit", "salt", "angle", "drop", "sigma", "add",
                            "flips", "mul_pc", "mul", "contrast")}
    gh, gw = ta.dropout_grid(h, w)
    for i in range(n):
        ks = jax.random.split(keys[1 + i], 18)
        order = iter(range(18))
        for op in ops:
            apply[op].append(bool(jax.random.uniform(ks[next(order)])
                                  < ta._GATE_P[op]))
            k = ks[next(order)]
            if op == "pepper":
                k1, k2 = jax.random.split(k)
                # JAX's shapes [h, w, 1]: the same bits as [h, w]
                vals["hit"].append(
                    jax.random.uniform(k1, (h, w, 1))[..., 0] < 0.05)
                vals["salt"].append(
                    jax.random.uniform(k2, (h, w, 1))[..., 0] < 0.5)
            elif op == "motion":
                vals["angle"].append(jax.random.uniform(
                    k, (), minval=0.0, maxval=jnp.pi))
            elif op == "dropout":
                vals["drop"].append(jax.random.uniform(k, (gh, gw)) < 0.1)
            elif op == "blur":
                vals["sigma"].append(jax.random.uniform(
                    k, (), minval=0.0, maxval=1.0))
            elif op == "add":
                vals["add"].append(ja._per_channel_values(k, 0.3, -20.0,
                                                          20.0))
            elif op == "invert":
                vals["flips"].append(jax.random.uniform(k, (3,)) < 0.2)
            elif op == "mul_pc":
                vals["mul_pc"].append(ja._per_channel_values(k, 0.8, 0.7,
                                                             1.4))
            elif op == "mul":
                vals["mul"].append(ja._per_channel_values(k, 0.0, 0.7, 1.4))
            else:
                vals["contrast"].append(ja._per_channel_values(k, 0.3, 0.5,
                                                               2.0))
    t = {k: torch.from_numpy(np.stack([np.asarray(x) for x in v]))
         for k, v in vals.items() if v}
    return ta.AugmentDraws(
        sample=torch.from_numpy(sample.copy()),
        apply={k: torch.tensor(v) for k, v in apply.items()}, **t)


def _images(n, h=32, w=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)


def _key_with_all_gates_open(n, h, w, pepper, motion, op):
    """A key whose draws apply `op` on at least one sample that passes
    the 0.8 gate."""
    for s in range(500):
        key = jax.random.PRNGKey(s)
        d = jax_augment_draws(key, n, h, w, pepper, motion)
        if bool((d.apply[op] & d.sample).any()):
            return key, d
    raise AssertionError(op)


OP_FNS = {
    "pepper": (lambda k, x: ja._salt_and_pepper(k, x),
               lambda x, d: ta.salt_and_pepper(x, d.hit, d.salt)),
    "motion": (lambda k, x: ja._motion_blur(k, x),
               lambda x, d: ta.motion_blur(x, d.angle)),
    "dropout": (lambda k, x: ja._coarse_dropout(k, x),
                lambda x, d: ta.coarse_dropout(x, d.drop)),
    "blur": (lambda k, x: ja._gaussian_blur(k, x),
             lambda x, d: ta.gaussian_blur(x, d.sigma)),
    "add": (lambda k, x: ja._add(k, x),
            lambda x, d: torch.clamp(x + d.add[:, None, None], 0, 255)),
    "invert": (lambda k, x: ja._invert(k, x),
               lambda x, d: torch.where(d.flips[:, None, None], 255.0 - x,
                                        x)),
    "mul_pc": (lambda k, x: ja._multiply(k, x, 0.8),
               lambda x, d: torch.clamp(x * d.mul_pc[:, None, None], 0,
                                        255)),
    "mul": (lambda k, x: ja._multiply(k, x, 0.0),
            lambda x, d: torch.clamp(x * d.mul[:, None, None], 0, 255)),
    "contrast": (lambda k, x: ja._linear_contrast(k, x),
                 lambda x, d: torch.clamp(
                     127.0 + d.contrast[:, None, None] * (x - 127.0), 0,
                     255)),
}


@pytest.mark.parametrize("op", list(OP_FNS))
def test_each_op_matches_jax(op):
    """Each op alone, sample by sample, on the values the JAX op draws
    from its key (the op key of the recipe's key order)."""
    n, h, w = 3, 32, 40
    imgs = _images(n, h, w, seed=1)
    key = jax.random.PRNGKey(7)
    d = jax_augment_draws(key, n, h, w, True, True)
    keys = jax.random.split(key, n + 1)
    ops = ["pepper", "motion"] + list(ta._OPS)
    want = np.stack([np.asarray(OP_FNS[op][0](
        jax.random.split(keys[1 + i], 18)[2 * ops.index(op) + 1],
        jnp.asarray(imgs[i]))) for i in range(n)])
    got = OP_FNS[op][1](torch.from_numpy(imgs), d).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("pepper,motion", [(False, False), (True, True),
                                           (True, False)])
def test_augment_batch_matches_jax(pepper, motion):
    n, h, w = 6, 32, 40
    imgs = _images(n, h, w, seed=2)
    for op in ["blur", "contrast"] + (["motion"] if motion else []):
        key, d = _key_with_all_gates_open(n, h, w, pepper, motion, op)
        want = np.asarray(ja.augment_batch(jnp.asarray(imgs), key, pepper,
                                           motion))
        got = ta.augment_batch(torch.from_numpy(imgs), d).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=MOTION_TOL if motion else TOL)
        # the 0.8 gate keeps some samples as they were
        keep = ~d.sample.numpy()
        np.testing.assert_array_equal(got[keep], imgs[keep])


def test_draw_augment_shapes_and_rates():
    g = torch.Generator().manual_seed(0)
    d = ta.draw_augment(g, 4000, 40, 20, True, True)
    assert ta.dropout_grid(256, 256) == (13, 13)
    assert d.drop.shape == (4000, 2, 1) and d.hit.shape == (4000, 40, 20)
    assert set(d.apply) == {"pepper", "motion"} | set(ta._OPS)
    assert abs(float(d.sample.float().mean()) - 0.8) < 0.03
    for op, p in ta._GATE_P.items():
        assert abs(float(d.apply[op].float().mean()) - p) < 0.03, op
    assert float(d.add.min()) >= -20 and float(d.add.max()) <= 20
    assert float(d.contrast.min()) >= 0.5 and float(d.contrast.max()) <= 2
    # the shared multiply (per-channel probability 0) repeats one value
    assert bool((d.mul == d.mul[:, :1]).all())
    assert float((d.mul_pc != d.mul_pc[:, :1]).any(1).float().mean()) > 0.7
    # no ops drawn for disabled options
    d2 = ta.draw_augment(torch.Generator().manual_seed(0), 4, 32, 32)
    assert d2.hit is None and d2.angle is None and "pepper" not in d2.apply
    # the same seed draws the same values
    d3 = ta.draw_augment(torch.Generator().manual_seed(0), 4, 32, 32)
    assert torch.equal(d2.sigma, d3.sigma) and torch.equal(d2.drop, d3.drop)


@pytest.mark.parametrize("method", ["crop_square_resize", "crop_resize",
                                    "crop_resize_by_warp_affine"])
def test_training_preprocess_batch_matches_jax(method):
    """The training branch of preprocess_batch (crop, augment on the f32
    256-side crop, normalize, GT planes) with JAX's augmentation draws
    injected. Crop 48 -> GT 24 at b3."""
    rng = np.random.default_rng(3)
    n, H, W = 3, 60, 80
    raw = {"rgb": rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8),
           "label": rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8),
           "mask": (rng.random((n, H, W)) > 0.5).astype(np.uint8) * 255,
           "entire_mask": (rng.random((n, H, W)) > 0.4).astype(np.uint8)
           * 255, "valid": np.array([1, 1, 0], np.float32)}
    if method == "crop_resize_by_warp_affine":
        raw["roi_param"] = np.array([[40.5, 30.2, 30.0], [20.0, 25.0, 44.0],
                                     [60.0, 10.0, 20.0]], np.float32)
    elif method == "crop_square_resize":
        raw["roi_param"] = np.array([[10, 5, 50, 45, 40], [-6, 20, 30, 56, 36],
                                     [50, 30, 90, 70, 40]], np.int32)
    else:
        raw["roi_param"] = np.array([[10, 5, 40, 30], [0, 20, 30, 40],
                                     [50, 30, 30, 30]], np.int32)
    key = jax.random.PRNGKey(11)
    want = j_preprocess({k: jnp.asarray(v) for k, v in raw.items()}, key,
                        crop_img=48, crop_gt=24, is_train=True,
                        resize_method=method, use_pepper_salt=True,
                        use_motion_blur=True)
    draws = jax_augment_draws(key, n, 48, 48, True, True)
    got = preprocess_batch({k: torch.from_numpy(v) for k, v in raw.items()},
                           crop_img=48, crop_gt=24, resize_method=method,
                           is_train=True, use_pepper_salt=True,
                           use_motion_blur=True, draws=draws)
    assert sorted(got) == sorted(want)
    # normalized image: 1e-4 on [0, 255] is ~2e-6 after /255/std
    # the crops agree within 1e-3 on [0, 255] (test_torch_codec_roi), so
    # the normalized image is held as the inference branch's is
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(want["image"]),
                               atol=1e-4, rtol=0)
    for k in ("mask", "entire_mask", "code"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_training_preprocess_draws_from_the_generator():
    rng = np.random.default_rng(4)
    raw = {"rgb": torch.from_numpy(rng.integers(0, 256, (8, 40, 40, 3),
                                                dtype=np.uint8)),
           "roi_param": torch.tensor([[0, 0, 40, 40, 40]] * 8,
                                     dtype=torch.int32),
           "valid": torch.ones(8)}
    kw = dict(crop_img=32, crop_gt=16, is_train=True, include_gt=False)
    a = preprocess_batch(raw, generator=torch.Generator().manual_seed(5),
                         **kw)["image"]
    b = preprocess_batch(raw, generator=torch.Generator().manual_seed(5),
                         **kw)["image"]
    c = preprocess_batch(raw, generator=torch.Generator().manual_seed(6),
                         **kw)["image"]
    plain = preprocess_batch(raw, crop_img=32, crop_gt=16,
                             include_gt=False)["image"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, plain)
    with pytest.raises(ValueError, match="generator"):
        preprocess_batch(raw, **kw)
