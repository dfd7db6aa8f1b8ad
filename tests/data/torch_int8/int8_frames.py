"""`test --int8` frame by frame: the port against the JAX package, with
the JAX package's RANSAC draws injected into the port.

    JAX_PLATFORMS=cpu python tests/data/torch_int8/int8_frames.py DIR \
        [--max_samples N] [--batch_size 32] [--float]
        [--hypotheses [--frames I,J,...]]

DIR is a tree `python3 chip_smoke.py --write-tree DIR` writes. Both
stacks run `test`'s pieces on the CPU over DIR/lmo_ape.txt with the
committed checkpoint, `--int8` unless `--float`:

  * the JAX package's (`prepare_object_eval`, `ZebraPoseNet(quant=)`,
    `load_model_variables`, `make_eval_step`, `run_inference`,
    `pose_errors`), with the exact int8 convolution of
    `jax_int8_recall.py` in place of XLA's slow one;
  * the port's (`prepare_object_eval`, `load_model`, `make_eval_step`,
    `run_inference`, `pose_errors`), whose RANSAC uniforms are JAX's own
    for the same batch keys (`fold_in(PRNGKey(0), start)`, split per
    crop), through `run_inference(draws_for=)`.

It prints one JSON object: each stack's ADD recall@0.1d; per frame both
ADD errors and how many visible-mask pixels and code bits of the two
networks' hard outputs differ; the frames whose verdicts (error < 0.1 d)
differ; and, as yardsticks, how many of the JAX network's own hard bits
move on the first batch when its input crops get N(0, 1e-6) noise
(`noise_flips`, int8), and how many bits and verdicts a whole JAX run
with that noise moves against the clean one (`jax_vs_noisy_jax`).
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, "..", "..", ".."))
for p in (REPO, os.path.join(REPO, "tests"), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np

CKPT = os.path.join(REPO, "trained", "rehearsal3_best.npz")


def _exact_int8_conv():
    """A context in which JAX's int8 convolutions are the exact grouped
    float32 ones of jax_int8_recall.py (checked first)."""
    import contextlib

    import jax

    import jax_int8_recall

    @contextlib.contextmanager
    def ctx():
        jax_int8_recall.self_check()
        conv = jax.lax.conv_general_dilated
        jax.lax.conv_general_dilated = jax_int8_recall.exact_int8_conv
        try:
            yield
        finally:
            jax.lax.conv_general_dilated = conv

    return ctx()


def jax_run(root, max_samples=None, batch_size=32, int8=True, noise=0.0,
            flips=True):
    """The JAX package's `test` over root/lmo_ape.txt: a dict of R, t,
    ok, visible masks, codes, per-frame ADD errors, the diameter and,
    with `flips` (int8 only), the JAX network's bit flips under input
    noise on the first batch. `noise` > 0 adds N(0, noise) (fixed draws)
    to every crop the network sees."""
    import jax
    import jax.numpy as jnp

    from zebrapose_tpu.config import ZebraConfig
    from zebrapose_tpu.data.pipeline import preprocess_batch
    from zebrapose_tpu.eval import evaluate as jev
    from zebrapose_tpu.eval.runner import (
        load_model_variables,
        prepare_object_eval,
    )
    from zebrapose_tpu.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu.ops.binarize import code_from_logits
    from zebrapose_tpu.ops.pnp import PnPConfig

    cfg = ZebraConfig.from_file(os.path.join(root, "lmo_ape.txt"))
    oe = prepare_object_eval(cfg, "ape", max_samples=max_samples)
    model = ZebraPoseNet(binary_code_length=cfg.number_of_itration,
                         variant="v2", quant=int8)
    variables = load_model_variables(CKPT, model, "v2",
                                     cfg.BoundingBox_CropSize_image)
    crop = dict(crop_img=cfg.BoundingBox_CropSize_image,
                crop_gt=cfg.BoundingBox_CropSize_GT, base=2,
                n_bits=cfg.number_of_itration,
                resize_method=cfg.resize_method)
    def forward(b, v):
        image = b["image"]
        if noise:
            image = image + noise * jax.random.normal(
                jax.random.PRNGKey(1), image.shape, image.dtype)
        return model.apply(v, image, train=False)

    step = jev.make_eval_step(
        forward, oe.lut,
        loss_type=cfg.BinaryCode_Loss_Type, pnp_cfg=PnPConfig(),
        return_masks=True, return_codes=True, preprocess_gt=False, **crop)
    with _exact_int8_conv():
        Rs, ts, ok, vis, _, codes = jev.run_inference(
            oe.dataset, step, batch_size, variables=variables,
            collect_masks=True, collect_codes=True)
        n_flips = None
        if int8 and flips:
            raw = oe.dataset.collate(list(range(min(batch_size,
                                                    len(oe.dataset)))))
            image = preprocess_batch(
                {k: jnp.asarray(raw[k])
                 for k in ("rgb", "roi_param", "valid")},
                jax.random.PRNGKey(0), is_train=False, include_gt=False,
                **crop)["image"]
            noise = np.random.default_rng(0).normal(0, 1e-6, image.shape)
            bits = [np.asarray(code_from_logits(model.apply(
                variables, im, train=False)["code"])) for im in
                (image, image + jnp.asarray(noise, image.dtype))]
            n_flips = int((bits[0] != bits[1]).sum())
    Rs[~ok] = np.eye(3)
    ts[~ok] = 0
    errors = np.asarray(jev.pose_errors(oe.dataset, Rs, ts, ok,
                                        oe.vertices, oe.symmetric))
    return dict(R=Rs, t=ts, ok=ok, vis=np.asarray(vis),
                code=np.asarray(codes), errors=errors,
                diameter=oe.diameter, noise_flips=n_flips)


def port_run(root, max_samples=None, batch_size=32, int8=True):
    """The port's `test` over root/lmo_ape.txt on the CPU with the JAX
    package's draws: a dict as jax_run's, without noise_flips."""
    import jax

    from test_torch_pnp import jax_ransac_draws
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.eval.evaluate import (
        make_eval_step,
        pose_errors,
        run_inference,
    )
    from zebrapose_tpu_torch.eval.runner import load_model, prepare_object_eval
    from zebrapose_tpu_torch.ops.pnp import PnPConfig

    cfg = ZebraConfig.from_file(os.path.join(root, "lmo_ape.txt"))
    oe = prepare_object_eval(cfg, "ape", max_samples=max_samples)
    model = load_model(cfg, CKPT, device="cpu", quant=int8)
    pnp_cfg = PnPConfig()
    gt = cfg.BoundingBox_CropSize_GT
    step = make_eval_step(
        lambda b: model(b["image"]), oe.lut,
        crop_img=cfg.BoundingBox_CropSize_image, crop_gt=gt, base=2,
        n_bits=cfg.number_of_itration, resize_method=cfg.resize_method,
        loss_type=cfg.BinaryCode_Loss_Type, pnp_cfg=pnp_cfg,
        return_masks=True, return_codes=True, preprocess_gt=False,
        device="cpu")

    def draws_for(start):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                   start), batch_size)
        return jax_ransac_draws(keys, gt * gt, pnp_cfg)

    Rs, ts, ok, vis, _, codes = run_inference(
        oe.dataset, step, batch_size, device="cpu", draws_for=draws_for,
        collect_masks=True, collect_codes=True)
    Rs[~ok] = np.eye(3)
    ts[~ok] = 0
    errors = np.asarray(pose_errors(oe.dataset, Rs, ts, ok, oe.vertices,
                                    oe.symmetric, device="cpu"))
    return dict(R=Rs, t=ts, ok=ok, vis=np.asarray(vis),
                code=np.asarray(codes), errors=errors)


def _differences(a, b, thr):
    """Per-frame hard-bit differences and differing verdicts of two
    runs."""
    av, bv = a["errors"] < thr, b["errors"] < thr
    n = len(av)
    return ((a["vis"] != b["vis"]).reshape(n, -1).sum(-1),
            (a["code"] != b["code"]).reshape(n, -1).sum(-1),
            np.flatnonzero(av != bv))


def compare(root, max_samples=None, batch_size=32, int8=True,
            noise_run=True):
    """Both stacks' runs side by side (a dict, module docstring); with
    `noise_run`, also JAX against itself with N(0, 1e-6) on its crops
    (`jax_vs_noisy_jax`): how far rounding alone moves the verdicts."""
    j = jax_run(root, max_samples, batch_size, int8)
    p = port_run(root, max_samples, batch_size, int8)
    thr = 0.1 * j["diameter"]
    jv, pv = j["errors"] < thr, p["errors"] < thr
    n = len(jv)
    mask_px, code_bits, _ = _differences(j, p, thr)
    noisy = {}
    if noise_run:
        jn = jax_run(root, max_samples, batch_size, int8, noise=1e-6,
                     flips=False)
        m, c, d = _differences(j, jn, thr)
        noisy = {"recall_noisy_jax": float((jn["errors"] < thr).mean()),
                 "differing": d.tolist(),
                 "frames_bits_equal": int(((m == 0) & (c == 0)).sum()),
                 "mean_code_bits": float(c.mean()),
                 "mean_mask_px": float(m.mean())}
    return {
        "int8": int8, "frames": n, "batch_size": batch_size,
        "recall_jax": float(jv.mean()), "recall_port": float(pv.mean()),
        "differing": [{"frame": int(i), "jax_err": float(j["errors"][i]),
                       "port_err": float(p["errors"][i]),
                       "mask_px": int(mask_px[i]),
                       "code_bits": int(code_bits[i])}
                      for i in np.flatnonzero(jv != pv)],
        "frames_bits_equal": int(((mask_px == 0) & (code_bits == 0)).sum()),
        "mask_px": mask_px.tolist(), "code_bits": code_bits.tolist(),
        "code_bits_per_frame": int(j["code"][0].size),
        "noise_flips": j["noise_flips"], "jax_vs_noisy_jax": noisy,
        "jax_errors": j["errors"].tolist(),
        "port_errors": p["errors"].tolist(), "diameter": j["diameter"]}


def hypothesis_stage(root, frames, batch_size=32):
    """Where two float runs with equal bits and equal draws part: for the
    crops `frames` (indices into the tree, drawn as `test` draws them at
    `batch_size`), the port's float masks and codes (equal to JAX's on
    those frames, `compare(int8=False)`) go through both stacks'
    correspondences, subsets and minimal sets (compared exactly) and
    their minimal-set EPnP (the JAX package's jnp reference, the port's
    plain version), each held to the port's plain version in float64 on
    the same sets. Returns per crop the largest subset / sample
    difference and the median |dR| of the hypotheses: JAX vs the port,
    JAX vs float64, the port vs float64."""
    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_pnp import jax_ransac_draws
    from zebrapose_tpu.ops import pnp as jp
    from zebrapose_tpu.ops.pnp_kernel import minimal_epnp_hypotheses
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.eval.runner import prepare_object_eval
    from zebrapose_tpu_torch.ops import pnp as tp
    from zebrapose_tpu_torch.ops.pnp_kernel import (
        minimal_epnp_hypotheses_reference as plain,
    )

    frames = sorted(frames)
    run = port_run(root, frames[-1] + 1, batch_size, int8=False)
    oe = prepare_object_eval(
        ZebraConfig.from_file(os.path.join(root, "lmo_ape.txt")), "ape",
        max_samples=frames[-1] + 1)
    cfg = jp.PnPConfig()
    out = []
    for i in frames:
        raw = oe.dataset.collate([i])
        start = i - i % batch_size          # the batch's key, as `test`'s
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0),
                                                   start), batch_size)
        key = keys[i - start]
        K = raw["K"][0].astype(np.float32)
        bbox = raw["final_bbox"][0].astype(np.int32)
        mask, code = run["vis"][i].astype(np.float32), run["code"][i]
        j = jp._ransac_prepare(*jp._correspondences(
            jnp.asarray(mask), jnp.asarray(code), jnp.asarray(oe.lut.points),
            jnp.asarray(oe.lut.valid), jnp.asarray(bbox), 128, 2),
            jax.random.fold_in(key, 2), cfg)
        d = jax_ransac_draws(key[None], 128 * 128, cfg)
        t = tp._ransac_prepare(*tp._correspondences(
            torch.from_numpy(mask[None]), torch.from_numpy(code[None]),
            torch.from_numpy(oe.lut.points), torch.from_numpy(oe.lut.valid),
            torch.from_numpy(bbox[None]), 128, 2), tp.PnPConfig(), d.prio,
            d.u)
        setdiff = max(float(np.abs(np.asarray(a, np.float64)
                                   - b[0].double().numpy()).max())
                      for a, b in zip(j, t))
        Ks = np.repeat(K[None], j[3].shape[0], 0)
        rj = np.asarray(minimal_epnp_hypotheses(
            j[3], j[4], jnp.asarray(Ks), cfg.gn_iters, use_kernel=False)[0])
        rt = plain(t[3][0], t[4][0], torch.from_numpy(Ks))[0].numpy()
        r64 = plain(t[3][0].double(), t[4][0].double(),
                    torch.from_numpy(Ks).double())[0].numpy()

        def med(a, b):
            return float(np.median(np.abs(a - b).reshape(len(a), -1)
                                   .max(-1)))

        out.append({"frame": i, "sets_max_diff": setdiff,
                    "dR_jax_port": med(rj, rt), "dR_jax_f64": med(rj, r64),
                    "dR_port_f64": med(rt, r64)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--max_samples", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--float", action="store_true",
                    help="the float network instead of --int8")
    ap.add_argument("--no_noise_run", action="store_true",
                    help="skip JAX against itself under input noise")
    ap.add_argument("--hypotheses", action="store_true",
                    help="only hypothesis_stage, on the frames whose float "
                    "verdicts differ (a float compare without the noise "
                    "run finds them) or on --frames")
    ap.add_argument("--frames", type=lambda v: [int(f) for f in
                                                v.split(",")],
                    help="comma-separated frame indices for --hypotheses")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    if args.hypotheses:
        # with no --frames, each frame's record also carries its float
        # compare entry (both ADD errors, mask pixels and code bits apart)
        found = {} if args.frames else {d["frame"]: d for d in compare(
            root, args.max_samples, args.batch_size, int8=False,
            noise_run=False)["differing"]}
        out = hypothesis_stage(root, args.frames or list(found),
                               args.batch_size)
        print(json.dumps([{**found.get(r["frame"], {}), **r} for r in out]))
        return 0
    res = compare(root, args.max_samples,
                  args.batch_size, int8=not args.float,
                  noise_run=not args.no_noise_run)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
