"""Drive the PyTorch port's inference path on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --baseline OLD.cu --baseline-intrinsics fxfycxcy

Builds the port's CUDA kernels from `zebrapose_tpu_torch/csrc/`, holds
each against its plain PyTorch version, runs the main path (480x640
frames -> 256² crops -> ZebraPoseNet v2 with the committed weights ->
decode -> EPnP-RANSAC) at b32 and b256, with and without escalation,
and times it. Inputs are made with numpy from fixed seeds. Any failed
check exits non-zero. Phases:

  1. device      the card, its power limit
  2. build       nvcc of every kernel source (registers / spills),
                 the kernel's occupancy as the CUDA runtime reports it
  3. kernel      minimal-set EPnP kernel vs its plain version, on noisy
                 sets and on edge sets (coincident, collinear,
                 near-collinear, near-planar; gn_iters 5 and 0)
  4. decode      exact-geometry decode, CUDA (kernel) vs CPU (plain)
  5. main path   make_eval_step at full width, f32 logits vs the CPU
  6. timing      kernel (a loop of launches between two CUDA events, and
                 its device time under torch.profiler) vs plain vs bound
  7. runner      `python -m zebrapose_tpu_torch test` (cli.main, in this
                 process) over a BOP tree the port writes: 120 sphere
                 frames whose rgb rows cycle through PNG filters 0-4, the
                 committed rehearsal LUT and checkpoint, b32, plain and
                 escalated; the collated frames against the written
                 ones, the CSV, the kernel's launches, the runner against
                 a direct make_eval_step call on the first batch, ADD
                 recall against the JAX package's on the same tree; the
                 command's time by stage as run_test logs it; recall
                 over RANSAC seeds 0-3 with cuDNN TF32 on and off

`--write-tree DIR` writes phase 7's tree (and its config) on the CPU and
stops: the JAX package's `test` command runs on it for the reference
recall.

`--baseline OLD.cu` also builds another version of
`csrc/epnp_minimal.cu` with the same C interface and times it against
the current one in turns (old, new, new, old) by the same method;
`--baseline-intrinsics fxfycxcy` says that its third argument is
[N, 4] (fx, fy, cx, cy) rather than Ks [N, 3, 3].

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K_LMO = np.array([[572.4114, 0, 325.2611],
                  [0, 573.57043, 242.04899],
                  [0, 0, 1]], np.float32)
CKPT = os.path.join(HERE, "trained", "rehearsal3_best.npz")
# the checkpoint's surface code: the partition of uv_sphere() by the JAX
# package's generate_mesh_surface_code (base 2, 16 levels, seed 0)
LUT = os.path.join(HERE, "trained", "rehearsal3_lut.npz")
SPHERE_RADIUS = 40.0      # the rehearsal object: a position-coded sphere
TREE_FRAMES, TREE_SEED = 120, 3     # the runner phase's BOP tree
# ADD recall@0.1d of the JAX package on that tree: `python -m
# zebrapose_tpu test --batch_size 32` (and `--escalate_h 256`) with
# JAX_PLATFORMS=cpu, JAX 0.9.0 on an x86 host's CPU. The card's recall
# must reach each less RECALL_SLACK.
JAX_CPU_RECALL = {"plain": 0.7833333333333333,
                  "escalated": 0.7833333333333333}
RECALL_SLACK = 0.10

# H100 peaks (NVIDIA data sheet, dense, at the 700 W limit):
# (FP32 non-tensor FLOP/s, HBM bytes/s)
_PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def rot_deg(Ra, Rb):
    tr = np.einsum("nij,nij->n", Ra, Rb)
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1, 1)))


def orth_err(R):
    return float(np.abs(np.einsum("nij,nkj->nik", R, R) - np.eye(3))
                 .max(initial=0.0))


def time_ms(fn, iters=20, warmup=3):
    """Per-call device time in ms over `iters` calls, each bracketed by
    CUDA events, after `warmup` calls: (median, min, max)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), min(times), max(times)


def time_launches(fn, launches=100, repeats=5):
    """ms a launch: one pair of CUDA events around `launches` calls of
    `fn` on inputs made beforehand, over the count; one figure for each
    of `repeats` runs, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / launches)
    return out


def profiled_ms(fn, name, launches=20):
    """Mean device time in ms of the CUDA kernels whose name holds
    `name`, under torch.profiler over `launches` calls; None when the
    profiler sees no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name in e.key]
    if not ev or not sum(e.count for e in ev):
        return None
    return (sum(e.self_device_time_total for e in ev)
            / sum(e.count for e in ev) / 1e3)


def stats(xs):
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs))}


def epnp_operations(gn_iters: int) -> int:
    """Float operations of one minimal-set solve as the kernel runs it
    (add, sub, mul, div, sqrt, pow; an FMA counts 2), stage by stage."""
    def solve_ls(k):            # 6-row normal equations + Cholesky
        chol = sum(2 * j + 2 + (k - 1 - j) * (2 * j + 1)
                   for j in range(k)) + 1
        return 11 * k * (k + 1) // 2 + 3 * k - 1 + 11 * k + chol + 2 * k * k
    control = 116
    mtm = 6 * (9 + 10 * 15)
    chol12 = sum(2 * j + 2 + (11 - j) * (2 * j + 1) for j in range(12)) + 1
    subspace = 13 + 156 + chol12 + 4 * 4 * 288 + 4 * 430 + 4 * 300
    l6x10 = 6 * 101
    cases = solve_ls(4) + 9 + solve_ls(3) + 4 + solve_ls(5) + 6
    gn = 3 * gn_iters * (192 + 10 + 120 + solve_ls(4) + 4)
    polar = 45 + 12 * 89
    pose = 3 * (84 + 126 + 6 + 18 + 18 + 153 + polar + 18)
    reproj = 3 * (6 * 32 + 1)
    return control + mtm + subspace + l6x10 + cases + gn + pose + reproj


def random_poses(n, rng):
    R0 = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                   for _ in range(n)])
    R0[np.linalg.det(R0) < 0] *= -1
    t0 = np.concatenate([rng.uniform(-30, 30, (n, 2)),
                         rng.uniform(450, 650, (n, 1))], -1)
    return R0, t0


def project(pw, R0, t0):
    """Pixels of model points pw [n, 6, 3] under (R0, t0), LM-O K."""
    pc = np.einsum("nij,npj->npi", R0, pw) + t0[:, None, :]
    return np.stack([K_LMO[0, 0] * pc[..., 0] / pc[..., 2] + K_LMO[0, 2],
                     K_LMO[1, 1] * pc[..., 1] / pc[..., 2] + K_LMO[1, 2]],
                    -1).astype(np.float32)


def minimal_sets(n, noise, rng):
    """Noisy 6-point sets under random poses (LM-O intrinsics)."""
    pw = rng.uniform(-40, 40, (n, 6, 3)).astype(np.float32)
    R0, t0 = random_poses(n, rng)
    uv = project(pw, R0, t0)
    uv += rng.normal(0, noise, uv.shape).astype(np.float32)
    return pw, uv, R0


EDGE_KINDS = ("coincident", "collinear", "near_collinear", "near_planar")


def edge_sets(kind, n, rng):
    """Degenerate and near-degenerate 6-point sets, the cases a split of
    one solve over several threads could break: six copies of one point
    (integer coordinates, so that their mean is the point whatever the
    order of summation, and the spread exactly 0; pixels drawn at
    random), six points on a line, a line with 5 mm of scatter, a plane
    with 0.5 mm of scatter (exact projections under random poses, LM-O
    intrinsics)."""
    if kind == "coincident":
        pw = np.repeat(rng.integers(-40, 41, (n, 1, 3)), 6, axis=1)
        return (pw.astype(np.float32),
                rng.uniform(200, 300, (n, 6, 2)).astype(np.float32))
    if kind in ("collinear", "near_collinear"):
        d = rng.normal(size=(n, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pw = rng.uniform(-40, 40, (n, 1, 3)) + rng.uniform(-40, 40,
                                                           (n, 6, 1)) * d
        if kind == "near_collinear":
            pw = pw + rng.normal(0, 5.0, pw.shape)
    elif kind == "near_planar":
        pw = rng.uniform(-40, 40, (n, 6, 3))
        pw[..., 2] = rng.normal(0, 0.5, (n, 6))
    else:
        raise ValueError(kind)
    pw = pw.astype(np.float32)
    return pw, project(pw, *random_poses(n, rng))


def case_errors(samp3d, samp2d, Ks, gn_iters):
    """The plain version's reprojection error of each of the three beta
    cases [n, 3] (NaN -> +inf), the errors its choice compares."""
    import torch

    from zebrapose_tpu_torch.ops import pnp
    from zebrapose_tpu_torch.ops.fast_linalg import smallest_subspace

    w = torch.ones(samp3d.shape[:2], dtype=samp3d.dtype,
                   device=samp3d.device)
    ctrl_w, alphas = pnp._control_points(samp3d, w)
    V = smallest_subspace(pnp._build_mtm(alphas, samp2d, w, Ks), k=4)
    L, rho = pnp._l6x10_and_rho(V, ctrl_w)
    betas = torch.stack([pnp._betas_case1(L, rho), pnp._betas_case2(L, rho),
                         pnp._betas_case3(L, rho)], dim=-2)
    betas = pnp._gauss_newton_betas(L[:, None], rho[:, None], betas,
                                    gn_iters)
    Rs, ts = pnp._pose_from_betas(betas, V[:, None], alphas[:, None],
                                  samp3d[:, None], w[:, None])
    err = ((pnp.project_points(samp3d[:, None], Rs, ts, Ks[:, None])
            - samp2d[:, None]) ** 2).sum(-1).mean(-1)
    return torch.where(torch.isnan(err), torch.inf, err), Rs, ts


def relief_scene(rng, B=8, G=64, bits=16):
    """B instances of a 64² crop whose codes index LUT points that are
    exact back-projections of a depth-relief surface under a random
    pose (final bbox (100, 70, 96, 96))."""
    lut_pts = rng.uniform(-40, 40, (2 ** bits, 3)).astype(np.float32)
    lut_valid = np.ones((2 ** bits,), bool)
    Kinv = np.linalg.inv(K_LMO.astype(np.float64))
    masks = np.zeros((B, G, G), np.float32)
    codes = np.zeros((B, G, G, bits), np.float32)
    bboxes = np.tile(np.array([[100, 70, 96, 96]], np.int32), (B, 1))
    R_gt = np.zeros((B, 3, 3))
    shifts = np.arange(bits - 1, -1, -1)
    nid = 1
    for b in range(B):
        R0 = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R0 *= np.sign(np.linalg.det(R0))
        t0 = np.array([0, 0, 600.0])
        R_gt[b] = R0
        for y in range(16, 48):
            for x in range(14, 50):
                ox, oy = int(1.5 * x + 100), int(1.5 * y + 70)
                d = 600.0 + 60 * np.sin(x * 0.35) * np.cos(y * 0.3)
                lut_pts[nid] = R0.T @ (Kinv @ np.array([ox * d, oy * d, d])
                                       - t0)
                masks[b, y, x] = 1.0
                codes[b, y, x] = (nid >> shifts) & 1
                nid += 1
    return masks, codes, lut_pts, lut_valid, bboxes, R_gt


def sphere_frames(B, rng):
    """480x640 BGR frames of the rehearsal object (a radius-40 sphere
    whose color codes its surface position) at random poses over random
    background with pixel noise; returns frames, bboxes [B, 4] (x, y, w,
    h of the hit mask), hit masks [B, 480, 640] and poses (R [B, 3, 3],
    t [B, 3]: camera point = R · model point + t)."""
    ys, xs = np.mgrid[0:480, 0:640]
    rays = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3) @ \
        np.linalg.inv(K_LMO.astype(np.float64)).T            # [P, 3]
    rr = (rays * rays).sum(-1)
    frames = np.empty((B, 480, 640, 3), np.uint8)
    hits = np.empty((B, 480, 640), bool)
    bboxes, Rs, ts = [], [], []
    for b in range(B):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        t = np.array([rng.uniform(-40, 40), rng.uniform(-30, 30),
                      rng.uniform(480, 650)])
        dt = rays @ t
        disc = dt * dt - rr * (t @ t - SPHERE_RADIUS ** 2)
        hit = disc >= 0
        s = (dt - np.sqrt(np.where(hit, disc, 0))) / rr
        pm = (s[:, None] * rays - t) @ R                       # model frame
        color = (pm / SPHERE_RADIUS * 0.5 + 0.5) * 255
        bg = rng.integers(0, 255, (480 * 640, 3))
        img = np.where(hit[:, None], color, bg) + rng.normal(
            0, 6, (480 * 640, 3))
        frames[b] = np.clip(img, 0, 255).astype(np.uint8).reshape(480, 640, 3)
        hits[b] = hit.reshape(480, 640)
        hy, hx = np.nonzero(hits[b])
        bboxes.append([hx.min(), hy.min(), hx.max() - hx.min() + 1,
                       hy.max() - hy.min() + 1])
        Rs.append(R)
        ts.append(t)
    return frames, np.array(bboxes), hits, (np.array(Rs), np.array(ts))


def uv_sphere(n_theta=260, n_phi=270, radius=SPHERE_RADIUS):
    """The rehearsal object's mesh: a 70200-vertex UV sphere (more
    vertices than the 2^16 classes of its surface code); vertices
    [n, 3] float32 and faces [m, 3]."""
    thetas = np.linspace(0, np.pi, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(thetas, phis, indexing="ij")
    pts = np.stack([radius * np.sin(T) * np.cos(P),
                    radius * np.sin(T) * np.sin(P),
                    radius * np.cos(T)], axis=-1).reshape(-1, 3)
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    a, c = idx[:-1], idx[1:]
    b, d = np.roll(a, -1, axis=1), np.roll(c, -1, axis=1)
    faces = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)],
                     axis=2).reshape(-1, 3)
    return pts.astype(np.float32), faces.astype(np.int64)


def write_tree(root, n_frames=TREE_FRAMES, seed=TREE_SEED):
    """Write the runner phase's BOP tree under `root` with the port's
    own writers: lmo, object ape (id 1), `n_frames` 480x640 sphere
    frames whose rgb rows cycle through PNG filters 0-4, masks from the
    hit mask, scene_camera / scene_gt / scene_gt_info, the UV-sphere
    mesh (diameter 80), camera.json, the committed rehearsal LUT as
    `models_GT_color/Class_CorresPoint000001.txt`, and a config file
    `<root>/lmo_ape.txt`. Returns (config path, rgb frames, masks)."""
    from zebrapose_tpu_torch.codec.lut import (
        CorrespondenceLUT,
        save_correspondence_lut,
    )
    from zebrapose_tpu_torch.data import png
    from zebrapose_tpu_torch.data.bop_io import save_ply

    ds = os.path.join(root, "lmo")
    pts, faces = uv_sphere()
    for d in ("models", "models_eval"):
        os.makedirs(os.path.join(ds, d), exist_ok=True)
        save_ply(os.path.join(ds, d, "obj_000001.ply"), pts, faces=faces)
        with open(os.path.join(ds, d, "models_info.json"), "w") as f:
            json.dump({"1": {"diameter": 2 * SPHERE_RADIUS}}, f)
    with open(os.path.join(ds, "camera.json"), "w") as f:
        json.dump({"cx": float(K_LMO[0, 2]), "cy": float(K_LMO[1, 2]),
                   "fx": float(K_LMO[0, 0]), "fy": float(K_LMO[1, 1]),
                   "width": 640, "height": 480, "depth_scale": 1.0}, f)
    with np.load(LUT) as z:
        lut = CorrespondenceLUT(z["points"], z["valid"], int(z["base"]),
                                int(z["n_digits"]))
        sha = str(z["text_sha256"])
    lut_txt = os.path.join(ds, "models_GT_color",
                           "Class_CorresPoint000001.txt")
    os.makedirs(os.path.dirname(lut_txt), exist_ok=True)
    save_correspondence_lut(lut_txt, lut)
    with open(lut_txt, "rb") as f:
        check(hashlib.sha256(f.read()).hexdigest() == sha,
              "the LUT's text form differs from the one it was made as")

    frames, bboxes, hits, (Rs, ts) = sphere_frames(
        n_frames, np.random.default_rng(seed))
    scene = os.path.join(ds, "test", "000001")
    for sub in ("rgb", "mask", "mask_visib"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    cam, gt, gti = {}, {}, {}
    cycle = np.arange(480) % 5
    masks = hits.astype(np.uint8) * 255
    for im in range(n_frames):
        png.imwrite(os.path.join(scene, "rgb", f"{im:06d}.png"), frames[im],
                    filters=cycle)
        for sub in ("mask", "mask_visib"):
            png.imwrite(os.path.join(scene, sub, f"{im:06d}_000000.png"),
                        masks[im])
        cam[str(im)] = {"cam_K": K_LMO.reshape(-1).tolist(),
                        "depth_scale": 1.0}
        gt[str(im)] = [{"cam_R_m2c": Rs[im].reshape(-1).tolist(),
                        "cam_t_m2c": ts[im].tolist(), "obj_id": 1}]
        gti[str(im)] = [{"bbox_visib": [int(v) for v in bboxes[im]],
                         "visib_fract": 1.0}]
    for name, obj in (("scene_camera", cam), ("scene_gt", gt),
                      ("scene_gt_info", gti)):
        with open(os.path.join(scene, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    cfg_path = os.path.join(root, "lmo_ape.txt")
    with open(cfg_path, "w") as f:
        f.write(f"bop_path = {root}\ndataset_name = lmo\n"
                "test_folder = test\nBoundingBox_CropSize_image = 256\n"
                "BoundingBox_CropSize_GT = 128\n"
                "divide_number_each_itration = 2\n"
                "number_of_itration = 16\n")
    return cfg_path, frames, masks


def png_decode_ms(frame, tmp):
    """ms to read one 480x640 BGR frame with the port's reader, by the
    filter its rows carry (median of 3 reads each)."""
    from zebrapose_tpu_torch.data import png

    out = {}
    for name, filters in (("none", 0), ("sub", 1), ("up", 2),
                          ("average", 3), ("paeth", 4),
                          ("cycle0-4", np.arange(480) % 5)):
        path = os.path.join(tmp, f"decode_{name}.png")
        png.imwrite(path, frame, filters=filters)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            png.imread(path)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(times))
    return out


def runner_phase(dev, card, tmp, n_frames=TREE_FRAMES):
    """Phase 7 (see the module docstring): the `test` command twice, on
    `dev`; returns its record (metrics, rates, launches)."""
    import torch

    from zebrapose_tpu_torch import cli
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.eval.evaluate import (
        batch_generator,
        evaluate_object,
        run_inference,
    )
    from zebrapose_tpu_torch.eval.runner import (
        build_eval_step,
        load_model,
        prepare_object_eval,
    )
    from zebrapose_tpu_torch.ops.pnp import PnPConfig
    from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses

    t0 = time.perf_counter()
    cfg_path, frames, masks = write_tree(os.path.join(tmp, "bop"), n_frames)
    n, bsz = len(frames), 32
    log(f"[runner] tree of {n} frames written in "
        f"{time.perf_counter() - t0:.1f} s")
    rec = {"frames": n, "batch": bsz, "card": card, "runs": {}}
    for name, extra in (("plain", []),
                        ("escalated", ["--escalate_h", "256"])):
        out = os.path.join(tmp, f"out_{name}")
        minimal_epnp_hypotheses.launches = 0      # this path's run
        t0 = time.perf_counter()
        rc = cli.main(["test", "--cfg", cfg_path, "--obj_name", "ape",
                       "--ckpt_file", CKPT, "--batch_size", str(bsz),
                       "--output_dir", out, "--device", str(dev)] + extra)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = minimal_epnp_hypotheses.launches
        check(rc == 0, f"{name}: test returned {rc}")
        check(launches >= -(-n // bsz), f"{name}: the kernel was launched "
              f"{launches} times over {-(-n // bsz)} batches")
        (run_dir,) = os.listdir(out)
        run_dir = os.path.join(out, run_dir)
        with open(os.path.join(run_dir, "pose_result_bop",
                               "lmo_ape.csv")) as f:
            rows = f.read().splitlines()
        check(rows[0] == "scene_id,im_id,obj_id,score,R,t,time"
              and [r.split(",")[:3] for r in rows[1:]]
              == [["1", str(i), "1"] for i in range(n)],
              f"{name}: the CSV does not hold one row per frame")
        with open(os.path.join(run_dir, "ADD_result.txt")) as f:
            metrics = {k: float(v) for k, v in
                       (ln.split() for ln in f.read().splitlines())}
        with open(os.path.join(run_dir, "log.txt")) as f:
            logged = dict(ln.split() for ln in f.read().splitlines()
                          if ln.split()[:1] and ln.split()[0] in metrics)
        check(len(metrics) == 6 and {k: float(v) for k, v in logged.items()}
              == metrics, f"{name}: ADD_result.txt / log.txt")
        with open(os.path.join(run_dir, "log.txt")) as f:
            (timing,) = [json.loads(ln.split(" ", 1)[1]) for ln in f
                         if ln.startswith("timing ")]
        want = JAX_CPU_RECALL[name] - RECALL_SLACK
        log(f"[runner] {name}: ADD recall 0.1d "
            f"{metrics['ADD_recall_0.1d']:.4f} (JAX on a CPU "
            f"{JAX_CPU_RECALL[name]:.4f}, gate >= {want:.4f}),"
            f" 0.05d {metrics['ADD_recall_0.05d']:.4f}, 0.02d "
            f"{metrics['ADD_recall_0.02d']:.4f}, mean err "
            f"{metrics['ADD_mean_err']:.3f} mm, AUC step "
            f"{metrics['ADD_auc_step']:.4f}, AUC posecnn "
            f"{metrics['ADD_auc_posecnn']:.4f}; {n / wall:.2f} frames/s of "
            f"the whole command ({wall:.2f} s), {launches} kernel launches "
            f"on {card}")
        check(metrics["ADD_recall_0.1d"] >= want,
              f"{name}: ADD recall@0.1d below the JAX package's less "
              f"{RECALL_SLACK}")
        batches = -(-n // bsz)
        other = wall - sum(timing[k] for k in (
            "prepare_s", "load_model_s", "inference_s", "pose_errors_s",
            "write_s"))

        def share(s):
            return f"{s:.2f} s, {100 * s / wall:.1f}%"
        log(f"[runner] {name}: where the {wall:.2f} s went, timed in the "
            f"run: walk + LUT + mesh {share(timing['prepare_s'])}; model "
            f"load {share(timing['load_model_s'])}; run_inference "
            f"{share(timing['inference_s'])} (the device loop waited for "
            f"the host {share(timing['wait_s'])}, issued steps "
            f"{share(timing['step_s'])}, fetched poses "
            f"{share(timing['fetch_s'])}; the producer collated for "
            f"{timing['collate_s']:.2f} s on 4 decode threads); pose errors "
            f"{share(timing['pose_errors_s'])}; artifacts "
            f"{share(timing['write_s'])}; the rest {share(other)}"
            + ("" if "device_s" not in timing else
               f". The {batches} steps spanned "
               f"{share(timing['device_s'])} of the device stream "
               f"({1e3 * timing['device_s'] / batches:.2f} ms a batch; "
               f"CUDA events, so the span holds the host's issuing too)")
            + f" on {card}")
        rec["runs"][name] = {"metrics": metrics, "wall_s": wall,
                             "frames_per_s": n / wall, "launches": launches,
                             "timing": timing}

    # the frames the dataset collates are the frames written
    cfg = ZebraConfig.from_file(cfg_path)
    oe = prepare_object_eval(cfg, "ape")
    check(len(oe.dataset) == n, "the walk lost frames")
    batches = [oe.dataset.collate(list(range(s, min(s + bsz, n))))
               for s in range(0, n, bsz)]
    rows = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    for key, written in (("rgb", frames), ("mask", masks),
                         ("entire_mask", masks)):
        got = rows[key]
        check(got.dtype == written.dtype and got.shape == written.shape
              and got.tobytes() == written.tobytes(),
              f"collated {key} differs from what was written")
    decode = png_decode_ms(frames[0], tmp)
    log(f"[runner] PNG decode of one 480x640 BGR frame on the host, ms by "
        f"row filter: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                    decode.items()))

    # the runner's first batch = one direct make_eval_step call
    model = load_model(cfg, CKPT, "v2", device=dev)
    step = build_eval_step(cfg, model, oe.lut, PnPConfig(), device=dev)
    first = prepare_object_eval(cfg, "ape", max_samples=bsz).dataset
    R, t, ok = run_inference(first, step, batch_size=bsz, seed=0,
                             device=dev)
    raw = batches[0]
    feed = {k: raw[k] for k in ("rgb", "label", "mask", "entire_mask",
                                "roi_param", "valid")}
    args = (feed, raw["final_bbox"].astype(np.int32), raw["K"])
    Rd, td, okd, _ = (x.cpu().numpy() for x in step(
        *args, generator=batch_generator(0, 0, dev)))
    check(np.array_equal(R, Rd) and np.array_equal(t, td)
          and np.array_equal(ok, okd),
          "run_inference's first batch differs from make_eval_step's")
    log(f"[runner] first batch: run_inference = make_eval_step (R, t, "
        f"success equal; solved {ok.mean():.3f})")

    # recall@0.1d over RANSAC seeds 0-3, with cuDNN's TF32 convolutions
    # on (PyTorch's default, as in the runs above) and off: the draws'
    # spread against TF32's effect. The frames collated above are served
    # from memory, so no PNG decode runs beside the steps here.
    collated = _Collated(oe.dataset, rows)
    sweep, step_ms = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for allow in (True, False):
            torch.backends.cudnn.allow_tf32 = allow
            for name, pcfg in (
                    ("plain", PnPConfig()),
                    ("escalated", PnPConfig(escalate_hypotheses=256,
                                            escalate_inlier_frac=0.4))):
                st = build_eval_step(cfg, model, oe.lut, pcfg, device=dev)
                key = f"{name}, tf32 {'on' if allow else 'off'}"
                res = [evaluate_object(
                    collated, st, oe.vertices, oe.diameter, oe.symmetric,
                    oe.obj_id, cfg.dataset_name, "ape", batch_size=bsz,
                    seed=seed, device=dev) for seed in range(4)]
                sweep[key] = [r.metrics["ADD_recall_0.1d"] for r in res]
                step_ms[key] = [1e3 * r.timing["step_s"] / -(-n // bsz)
                                for r in res]
                log(f"[runner] recall@0.1d over seeds 0-3, {key}: "
                    + " ".join(f"{r:.4f}" for r in sweep[key])
                    + f" (mean {np.mean(sweep[key]):.4f}); a b{bsz} step "
                    f"issued in " + " ".join(f"{t:.1f}" for t in step_ms[key])
                    + f" ms (host clock; frames from memory) on {card}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rec.update(png_decode_ms=decode, recall_by_seed=sweep,
               sweep_step_ms=step_ms)
    return rec


class _Collated:
    """A dataset's frames collated once, served from memory to
    evaluate_object (its len, gts, rgb_files and collate)."""

    def __init__(self, dataset, rows):
        self.gts, self.rgb_files = dataset.gts, dataset.rgb_files
        self._rows = rows

    def __len__(self):
        return len(self.gts)

    def collate(self, indices, executor=None):
        return {k: v[list(indices)] for k, v in self._rows.items()}


def build_baseline(path):
    """Compile another version of csrc/epnp_minimal.cu with the port's
    flags into the build directory; its zp_epnp_minimal entry point."""
    from zebrapose_tpu_torch.ops import _build

    src = os.path.abspath(path)
    digest = hashlib.sha256(open(src, "rb").read()
                            + " ".join(_build.NVCC_FLAGS).encode())
    out = _build.BUILD_DIR / f"libbaseline_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(out), src], capture_output=True, text=True)
        check(res.returncode == 0, "baseline build failed:\n" + res.stdout
              + res.stderr)
    fn = ctypes.CDLL(str(out)).zp_epnp_minimal
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another version of "
                    "csrc/epnp_minimal.cu to time against the current one")
    ap.add_argument("--baseline-intrinsics", choices=("K", "fxfycxcy"),
                    default="K", help="the baseline's third argument: Ks "
                    "[N, 3, 3] or [N, 4] (fx, fy, cx, cy)")
    ap.add_argument("--write-tree", metavar="DIR",
                    help="write the runner phase's BOP tree (and its "
                    "config DIR/lmo_ape.txt) on the CPU, and stop")
    opts = ap.parse_args(argv)
    if opts.write_tree:
        sys.path.insert(0, HERE)
        cfg_path, _, _ = write_tree(os.path.abspath(opts.write_tree))
        log(f"[tree] {cfg_path}")
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
    from zebrapose_tpu_torch.eval.evaluate import make_eval_step
    from zebrapose_tpu_torch.models.convert import variables_to_state_dict
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu_torch.ops import _build
    from zebrapose_tpu_torch.ops.pnp import (
        PnPConfig,
        RansacDraws,
        decode_to_pose_batch,
        subset_pad_len,
    )
    from zebrapose_tpu_torch.ops.pnp_kernel import (
        _lib,
        minimal_epnp_hypotheses,
        minimal_epnp_hypotheses_reference,
        occupancy,
    )
    from zebrapose_tpu_torch.ops.roi import (
        final_bbox,
        padding_bbox,
        square_bbox,
    )
    from zebrapose_tpu_torch.utils.compact_ckpt import load_compact

    # ---- 1. device ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    peak_ops, peak_bw = _PEAKS["pcie" if "PCIe" in name else "sxm"]
    dev = torch.device("cuda")

    # ---- 2. build ------------------------------------------------------
    t0 = time.time()
    _build.build(["epnp_minimal"])
    log(f"[build] epnp_minimal.cu: {time.time() - t0:.1f} s")
    regs = [ln.strip() for ln in _build.build_log("epnp_minimal")
            .splitlines() if "registers" in ln or "spill" in ln]
    for ln in regs:
        log(f"[build]   {ln}")
    occ = occupancy()
    log(f"[build] epnp_minimal_kernel: {occ['registers']} registers, "
        f"{occ['local_bytes']} B local, {occ['smem_per_block']} B shared "
        f"memory and {occ['threads_per_block']} threads (32 solves, 4 "
        f"threads each) a block, {occ['blocks_per_sm']} blocks "
        f"({32 * occ['blocks_per_sm']} solves) resident per SM")
    baseline = (build_baseline(opts.baseline) if opts.baseline else None)

    # ---- 3. kernel vs plain version on minimal sets --------------------
    rng = np.random.default_rng(5)
    max_abs = 0.0
    # every N the driven paths launch: b32 (4096), the runner's escalated
    # stage 2 at b32 (8192), b256 (32768), [main]'s escalated b256 (65536)
    for n, noise in ((4096, 0.0), (4096, 0.5), (8192, 0.5), (32768, 0.5),
                     (65536, 0.5)):
        pw, uv, R0 = minimal_sets(n, noise, rng)
        a = torch.from_numpy(pw).to(dev)
        b = torch.from_numpy(uv).to(dev)
        Ks = torch.from_numpy(np.tile(K_LMO[None], (n, 1, 1))).to(dev)
        Rk, tk = minimal_epnp_hypotheses(a, b, Ks)
        torch.cuda.synchronize()
        Rp, tp = minimal_epnp_hypotheses_reference(a, b, Ks)
        Rk, tk, Rp, tp = (x.cpu().numpy() for x in (Rk, tk, Rp, tp))
        ang = rot_deg(Rk, Rp)
        dt = np.linalg.norm(tk - tp, axis=-1)
        max_abs = max(max_abs, float(np.abs(Rk - Rp).max()))
        log(f"[kernel] N={n} noise={noise}: rot deg p50 {np.median(ang):.2e}"
            f" p99 {np.percentile(ang, 99):.2e} max {ang.max():.2e} | t mm "
            f"p50 {np.median(dt):.2e} p99 {np.percentile(dt, 99):.2e} max "
            f"{dt.max():.2e} | orth {orth_err(Rk):.1e}")
        check(np.percentile(ang, 99) < 0.1, "kernel rot p99 >= 0.1 deg")
        check(np.percentile(dt, 99) < 0.5, "kernel t p99 >= 0.5 mm")
        check(orth_err(Rk) < 1e-4, "kernel R not orthonormal")
        if noise == 0.0:
            med = float(np.median(rot_deg(Rk, R0)))
            log(f"[kernel]   vs ground truth: median {med:.2e} deg")
            check(med < 0.05, "kernel misses exact minimal sets")

    # edge sets. Two f32 op orders of this algorithm (the JAX reference
    # and the plain version) part on most collinear sets and on the
    # ill-conditioned tail of the near-degenerate ones, so agreement is
    # held where the data determine it: R = 0 on coincident sets, the p99
    # gates on near-planar sets with Gauss-Newton, medians elsewhere. On
    # every set a finite non-zero R is orthonormal. Gauss-Newton on a
    # coincident set's R = 0 turns a few percent of them to NaN, more or
    # fewer with the op order; on the other sets the kernel makes no more
    # NaN poses than the plain version (+1% of the sets).
    erng = np.random.default_rng(11)
    for kind in EDGE_KINDS:
        for gn in (5, 0):
            n = 4096
            pw, uv = edge_sets(kind, n, erng)
            a = torch.from_numpy(pw).to(dev)
            b = torch.from_numpy(uv).to(dev)
            Ks = torch.from_numpy(np.tile(K_LMO[None], (n, 1, 1))).to(dev)
            Rk, tk = minimal_epnp_hypotheses(a, b, Ks, gn)
            torch.cuda.synchronize()
            Rp, tp = minimal_epnp_hypotheses_reference(a, b, Ks, gn)
            what = f"[edge] {kind} gn_iters={gn}"
            if kind == "coincident":
                err = case_errors(a, b, Ks, gn)[0].cpu().numpy()
                least = err.min(1, keepdims=True)
                ties = int((((err == least).sum(1) >= 2)
                            & np.isfinite(least[:, 0])).sum())
            Rk, tk, Rp, tp = (x.cpu().numpy() for x in (Rk, tk, Rp, tp))
            nan_k = int((~np.isfinite(Rk).all((1, 2))).sum())
            nan_p = int((~np.isfinite(Rp).all((1, 2))).sum())
            fin = np.isfinite(Rk).all((1, 2)) & np.isfinite(Rp).all((1, 2))
            zero = (Rk == 0).all((1, 2))
            ang = rot_deg(Rk[fin], Rp[fin])
            dt = np.linalg.norm(tk[fin] - tp[fin], axis=-1)
            good = np.isfinite(Rk).all((1, 2)) & ~zero
            log(f"{what}: rot deg p50 {np.median(ang):.2e} p99 "
                f"{np.percentile(ang, 99):.2e} | t mm p50 {np.median(dt):.2e}"
                f" p99 {np.percentile(dt, 99):.2e} | NaN R {nan_k}/{nan_p} "
                f"(kernel/plain), R = 0 {int(zero.sum())}, orth "
                f"{orth_err(Rk[good]):.1e}"
                + (f", sets whose least error two cases share {ties}"
                   if kind == "coincident" else ""))
            check(orth_err(Rk[good]) < 1e-4, f"{what}: R not orthonormal")
            if kind == "coincident":
                check(((Rk == 0) | np.isnan(Rk)).all()
                      and ((Rp == 0) | np.isnan(Rp)).all()
                      and zero.sum() >= 0.75 * n
                      and (Rp == 0).all((1, 2)).sum() >= 0.75 * n,
                      f"{what}: R not exactly 0")
            else:
                check(nan_k <= nan_p + n // 100, f"{what}: NaN poses")
            if kind == "near_planar" and gn == 5:
                check(np.percentile(ang, 99) < 0.1
                      and np.percentile(dt, 99) < 0.5, f"{what}: p99")
            elif kind in ("near_collinear", "near_planar"):
                check(np.median(ang) < 0.25 and np.median(dt) < 2.5,
                      f"{what}: median")

    # ---- 4. exact-geometry decode: CUDA (kernel) vs CPU (plain) --------
    masks, codes, lut_pts, lut_valid, bboxes, R_gt = relief_scene(rng)
    B, G = masks.shape[:2]
    cfg4 = PnPConfig(n_hypotheses=64, max_points=1024)
    draws = RansacDraws(
        prio=torch.from_numpy(rng.random(
            (B, subset_pad_len(G * G, cfg4)), np.float32)),
        u=torch.from_numpy(rng.random((B, 64, cfg4.sample_size),
                                      np.float32)))
    args = (masks, codes, lut_pts, lut_valid, bboxes,
            np.tile(K_LMO[None], (B, 1, 1)))
    before = minimal_epnp_hypotheses.launches
    Rk, tk, okk, _ = (x.cpu().numpy() for x in decode_to_pose_batch(
        *args, bbox_size=G, cfg=cfg4, draws=draws, device="cuda"))
    check(minimal_epnp_hypotheses.launches == before + 1,
          "decode did not launch the kernel once")
    Rc, tc, okc, _ = (x.numpy() for x in decode_to_pose_batch(
        *args, bbox_size=G, cfg=cfg4, draws=draws, device="cpu"))
    ang, ang_gt = rot_deg(Rk, Rc), rot_deg(Rk, R_gt)
    dt = np.linalg.norm(tk - tc, axis=-1)
    log(f"[decode] B={B} {G}²: CUDA-vs-CPU rot deg max {ang.max():.2e}, "
        f"t mm max {dt.max():.2e}; vs GT rot deg max {ang_gt.max():.2e}; "
        f"orth {orth_err(Rk):.1e}; solved {okk.mean():.2f}/{okc.mean():.2f}")
    check(okk.all() and okc.all(), "exact-geometry decode failed")
    check(ang.max() < 0.05 and dt.max() < 0.5, "CUDA vs CPU decode differ")
    check(ang_gt.max() < 0.5, "decode misses ground truth")
    check(orth_err(Rk) < 1e-4, "decoded R not orthonormal")

    # ---- 5. the main path at full width --------------------------------
    variables, meta = load_compact(CKPT)
    head = variables["params"]["aspp"]["conv_1x1_4"]["conv"]["kernel"]
    n_bits = head.shape[-1] - 2
    sd = variables_to_state_dict(variables, "v2")
    model = ZebraPoseNet(binary_code_length=n_bits, variant="v2").eval()
    model.load_state_dict(sd, strict=True)
    model = model.to(dev, torch.bfloat16).to(
        memory_format=torch.channels_last)
    log(f"[main] checkpoint {os.path.relpath(CKPT, HERE)} (step "
        f"{meta.get('step')}), v2, {n_bits} bits, bf16 on {name}")

    frames, det, _, _ = sphere_frames(256, np.random.default_rng(7))
    params, fbs = [], []
    for bb in det:
        pb = padding_bbox(bb, 1.5)
        x1, y1, x2, y2, side = square_bbox(pb)
        params.append([x1, y1, x2, y2, max(side, 1)])
        fbs.append(final_bbox(pb, "crop_square_resize", 640, 480))
    lut = CorrespondenceLUT(
        np.random.default_rng(9).uniform(-40, 40, (2 ** n_bits, 3))
        .astype(np.float32), np.ones(2 ** n_bits, bool), 2, n_bits)

    def feed(bsz):
        raw = {"rgb": frames[:bsz],
               "roi_param": np.array(params[:bsz], np.int32),
               "valid": np.ones(bsz, np.float32)}
        return ({k: torch.from_numpy(v).to(dev) for k, v in raw.items()},
                torch.from_numpy(np.array(fbs[:bsz], np.int32)).to(dev),
                torch.from_numpy(np.tile(K_LMO[None], (bsz, 1, 1))).to(dev))

    def forward(batch):
        return model(batch["image"].to(torch.bfloat16))

    def step_for(cfg):
        return make_eval_step(forward, lut, crop_img=256, crop_gt=128,
                              base=2, n_bits=n_bits,
                              resize_method="crop_square_resize",
                              loss_type="BCE", pnp_cfg=cfg,
                              preprocess_gt=False, return_masks=True,
                              device="cuda")

    cfg = PnPConfig(n_hypotheses=128, max_points=2048)
    # the escalation gate set so stage 2 runs whenever a crop has
    # foreground (any pixel left out of the consensus)
    cfg_esc = PnPConfig(n_hypotheses=128, max_points=2048,
                        escalate_hypotheses=256, escalate_inlier_frac=1.0)
    step, step_esc = step_for(cfg), step_for(cfg_esc)
    gen = torch.Generator(device=dev).manual_seed(0)
    feeds = {32: feed(32), 256: feed(256)}

    minimal_epnp_hypotheses.launches = 0          # the main-path run
    runs = [(32, step, 1), (256, step, 1), (256, step_esc, 2)]
    results = []
    for bsz, st, want in runs:
        before = minimal_epnp_hypotheses.launches
        out = st(*feeds[bsz], generator=gen)
        torch.cuda.synchronize()
        check(minimal_epnp_hypotheses.launches == before + want,
              f"b{bsz}: kernel launches rose by "
              f"{minimal_epnp_hypotheses.launches - before}, not {want}")
        results.append((bsz, want, out))
    main_launches = minimal_epnp_hypotheses.launches

    for bsz, want, out in results:
        R, t, ok, n_in, vis, _ = (x.cpu().numpy() for x in out)
        check(R.shape == (bsz, 3, 3) and t.shape == (bsz, 3)
              and ok.shape == (bsz,), f"b{bsz}: output shapes")
        check(np.isfinite(R).all() and np.isfinite(t).all(),
              f"b{bsz}: non-finite pose")
        # A minimal set of six pixels that share one code has no 3D
        # spread; its EPnP rotation is the zero matrix, in the JAX
        # reference too, and RANSAC can keep it on random codes. Every
        # other R must be orthonormal.
        zero = (R == 0).all((1, 2))
        check(orth_err(R[~zero]) < 1e-4, f"b{bsz}: R not orthonormal")
        log(f"[main] b{bsz}{' escalated' if want == 2 else ''}: "
            f"solved_frac {ok.mean():.3f} (random LUT: not asserted), "
            f"mask fg frac {vis.mean():.3f}, mean inliers {n_in.mean():.1f}"
            f", zero-spread R {int(zero.sum())}")

    # one crop's f32 logits, cuDNN TF32 off for this check only
    with torch.no_grad():
        from zebrapose_tpu_torch.data.pipeline import preprocess_batch
        raw1 = {k: v[:1] for k, v in feeds[32][0].items()}
        img = preprocess_batch(raw1, 256, 128, include_gt=False)["image"]
        m32 = ZebraPoseNet(binary_code_length=n_bits, variant="v2").eval()
        m32.load_state_dict(sd, strict=True)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            on_card = {k: v.float().cpu() for k, v in
                       m32.to(dev)(img).items()}
        finally:
            torch.backends.cudnn.allow_tf32 = prev
        on_cpu = m32.cpu()(img.cpu())
        err = max(float((on_card[k] - on_cpu[k]).abs().max())
                  for k in on_cpu)
    log(f"[main] one crop f32 logits card vs CPU: max abs err {err:.2e}")
    check(err <= 1e-3, "f32 logits on the card differ from the CPU")

    rates = {}
    for bsz in (32, 256):
        ms, lo, hi = time_ms(lambda: step(*feeds[bsz], generator=gen),
                             iters=10, warmup=2)
        rates[bsz] = {"median": bsz / (ms / 1e3), "min": bsz / (hi / 1e3),
                      "max": bsz / (lo / 1e3)}
        log(f"[main] b{bsz}: {ms:.2f} ms/batch (min {lo:.2f}, max {hi:.2f})"
            f", {rates[bsz]['median']:.1f} crops/s (CUDA events, median of "
            f"10) on {card}")
    # where the b256 step's time goes, stage by stage
    raw, fb, Kb = feeds[256]
    with torch.no_grad():
        batch = preprocess_batch(raw, 256, 128, include_gt=False)
        logits = {k: v.float() for k, v in forward(batch).items()}
    from zebrapose_tpu_torch.ops.binarize import (
        code_from_logits,
        mask_from_logits,
    )
    from zebrapose_tpu_torch.ops.pnp import (
        _correspondences,
        _ransac_finish,
        _ransac_prepare,
    )
    lut_p = torch.from_numpy(lut.points).to(dev)
    lut_v = torch.from_numpy(lut.valid).to(dev)
    hard = (mask_from_logits(logits["mask"][..., 0]),
            code_from_logits(logits["code"]))

    def prepare():
        return _ransac_prepare(*_correspondences(
            *hard, lut_p, lut_v, fb, 128, 2), cfg, generator=gen)

    sub3d, sub2d, sub_w, s3, s2, n_fg = prepare()
    H = cfg.n_hypotheses
    Rs, ts = minimal_epnp_hypotheses(
        s3.reshape(-1, 6, 3), s2.reshape(-1, 6, 2),
        Kb.repeat_interleave(H, dim=0))
    stages = {
        "preprocess": lambda: preprocess_batch(raw, 256, 128,
                                               include_gt=False),
        "forward": lambda: forward(batch),
        "decode": lambda: decode_to_pose_batch(
            *hard, lut_p, lut_v, fb, Kb, bbox_size=128, cfg=cfg,
            generator=gen),
        "decode.prepare": prepare,
        "decode.hypotheses": lambda: minimal_epnp_hypotheses(
            s3.reshape(-1, 6, 3), s2.reshape(-1, 6, 2),
            Kb.repeat_interleave(H, dim=0)),
        "decode.finish": lambda: _ransac_finish(
            sub3d, sub2d, sub_w, Rs.reshape(256, H, 3, 3),
            ts.reshape(256, H, 3), Kb, n_fg, cfg),
    }
    with torch.no_grad():
        parts = {k: time_ms(f, iters=5, warmup=1)[0]
                 for k, f in stages.items()}
    log("[main] b256 stages ms: " + json.dumps(
        {k: round(v, 3) for k, v in parts.items()}))
    # how busy the card is during one b256 decode (torch.profiler)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stages["decode"]()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if kern:
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
        log(f"[main] b256 decode under the profiler: "
            f"{sum(e.count for e in kern)} kernels, device busy "
            f"{busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
            f"({100 * busy_ms / wall_ms:.1f}%)")
    else:
        log("[main] b256 decode under the profiler: no device kernels "
            "seen, device busy share not measured")

    # ---- 6. kernel timing vs plain version vs bound --------------------
    # The kernel's time is one pair of CUDA events around 100 launches of
    # its C entry point on inputs and outputs made beforehand, over the
    # count, 5 times; and its mean device time under torch.profiler. With
    # --baseline the other build is timed the same way in turns: old,
    # new, new, old.
    ops = epnp_operations(cfg.gn_iters)
    stream = torch.cuda.current_stream().cuda_stream
    timing, ab = {}, {}
    for n in (4096, 32768, 65536):
        pw, uv, _ = minimal_sets(n, 0.5, rng)
        a = torch.from_numpy(pw).to(dev)
        b = torch.from_numpy(uv).to(dev)
        Ks = torch.from_numpy(np.tile(K_LMO[None], (n, 1, 1))).to(dev)
        R = torch.empty((n, 3, 3), device=dev)
        t = torch.empty((n, 3), device=dev)
        ptrs = (a.data_ptr(), b.data_ptr(), Ks.data_ptr(), R.data_ptr(),
                t.data_ptr(), n, cfg.gn_iters, stream)
        new_fn = _lib()
        new = lambda: check(new_fn(*ptrs) == 0, "launch failed")  # noqa: E731
        if baseline is not None:
            cam = (Ks if opts.baseline_intrinsics == "K" else torch.stack(
                [Ks[:, 0, 0], Ks[:, 1, 1], Ks[:, 0, 2], Ks[:, 1, 2]],
                -1).contiguous())
            old_ptrs = ptrs[:2] + (cam.data_ptr(),) + ptrs[3:]
            old = lambda: check(baseline(*old_ptrs) == 0,  # noqa: E731
                                "baseline launch failed")
            runs = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                runs[which] += time_launches(old if which == "old" else new)
            ab[n] = {k: dict(stats(v), profiler_ms=profiled_ms(
                old if k == "old" else new, "epnp")) for k, v in runs.items()}
            k_runs = runs["new"]
        else:
            k_runs = time_launches(new)
        k_prof = (ab[n]["new"]["profiler_ms"] if baseline is not None
                  else profiled_ms(new, "epnp"))
        p_ms = time_ms(lambda: minimal_epnp_hypotheses_reference(a, b, Ks),
                       iters=5, warmup=1)[0]
        bytes_ = n * (18 + 12 + 9 + 9 + 3) * 4   # p3, p2, Ks in; R, t out
        b_ops, b_bytes = n * ops / peak_ops * 1e3, bytes_ / peak_bw * 1e3
        k = stats(k_runs)
        timing[n] = dict(ms=k["median"], ms_min=k["min"], ms_max=k["max"],
                         profiler_ms=k_prof, plain_ms=p_ms,
                         bound_ms=max(b_ops, b_bytes),
                         bound_by="operations" if b_ops >= b_bytes
                         else "bytes")
        prof = "not seen" if k_prof is None else f"{k_prof:.4f} ms"
        log(f"[timing] N={n}: kernel {k['median']:.4f} ms (min {k['min']:.4f}"
            f", max {k['max']:.4f}; {len(k_runs)} runs of 100 launches), "
            f"profiler {prof}, plain {p_ms:.3f} ms, bound "
            f"{timing[n]['bound_ms']:.5f} ms ({timing[n]['bound_by']}: {ops} "
            f"ops/solve at {peak_ops / 1e12:.0f} TFLOP/s, {bytes_} B at "
            f"{peak_bw / 1e12:.2f} TB/s) on {card}")
        if baseline is not None:
            o, w_ = ab[n]["old"], ab[n]["new"]
            log(f"[ab] N={n}: old {o['median']:.4f} ms (min {o['min']:.4f}, "
                f"max {o['max']:.4f}, profiler {o['profiler_ms']}), new "
                f"{w_['median']:.4f} ms (min {w_['min']:.4f}, max "
                f"{w_['max']:.4f}, profiler {w_['profiler_ms']}): "
                f"{o['median'] / w_['median']:.2f}x, turns old new new old, "
                f"on {card}")
    log("[timing] library_ms: null -- no single PyTorch call computes a "
        "minimal-set EPnP")

    # ---- 7. the test runner --------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        runner = runner_phase(dev, card, tmp)

    main_n = 256 * cfg.n_hypotheses                  # the b256 stage
    rec = {"name": "minimal_epnp_hypotheses", "route": "cuda",
           "source": "zebrapose_tpu_torch/csrc/epnp_minimal.cu",
           "replaces": "zebrapose_tpu/ops/pnp_kernel.py:402",
           "launches": main_launches, "max_abs_err": max_abs,
           "ms": timing[main_n]["ms"], "plain_ms": timing[main_n]["plain_ms"],
           "bound_ms": timing[main_n]["bound_ms"],
           "bound_by": timing[main_n]["bound_by"], "library_ms": None,
           "n": main_n, "status": "ok",
           "by_n": {str(n): v for n, v in timing.items()},
           "occupancy": occ,
           "crops_per_s": {str(k): v for k, v in rates.items()},
           "launches_by_path": {
               "main": main_launches,
               **{f"runner_{k}": v["launches"]
                  for k, v in runner["runs"].items()}},
           "runner": runner, "card": card}
    if ab:
        rec["ab"] = {str(n): v for n, v in ab.items()}
    log(json.dumps({"kernels": [rec]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
