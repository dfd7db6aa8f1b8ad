"""Drive the PyTorch port's inference, training and BOP paths on one card.

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
  8. train       a training split written into phase 7's tree (160
                 sphere frames, GT labels from the committed LUT); one
                 b8 train step on the card against the CPU (f32, TF32
                 off, the committed weights, injected augmentation);
                 `python -m zebrapose_tpu_torch train` (cli.main, in this
                 process) from scratch in bf16 at b32, 300 steps with pose
                 validation every 100 (the kernel's launches counted),
                 the loss's fall, the checkpoints, `test` on the best
                 one, a resume for 10 steps; ms a step (bf16, f32, and
                 streaming from PNG), the share spent waiting for a
                 batch, peak device memory
  9. bop         the BOP-challenge path over phase 7's tree, which also
                 holds analytic depth, a BOP19 target list and ~190
                 synthetic detections (duplicates, background boxes, one
                 under the threshold): `python -m zebrapose_tpu_torch
                 vivo` at b32 (the kernel's launches counted), then
                 `score-bop` on its CSV on the card (AR_vsd / mssd /
                 mspd; VSD's depth renders on the host) against the
                 port's own CPU scoring pair by pair and against the JAX
                 package's AR; again with the sphere's continuous
                 symmetry (314 transforms); one render of the host
                 rasterizer against the written analytic depth; the
                 time of each, split as the commands measure it
 10. prep        the data-preparation path: the committed JPEG / TIFF /
                 Adam7 fixtures decoded and held to cv2's hashes (the
                 progressive one refused), ms a 480x640 .jpg frame;
                 `generate-mesh-code` on the sphere's PLY against the
                 committed LUT (the partition's invariants if the
                 toolchain's partition differs); `generate-labels` over
                 phase 7's split, plain and with the sphere's continuous
                 symmetry, against the JAX package's label hashes; a
                 `train_pbr` split of 4 committed .jpg frames labelled by
                 `generate-labels`, and `train --from_scratch --bf16` on it
                 for 40 steps with one pose validation (the kernel's
                 launches counted, the .jpg and label reads counted)

`--write-tree DIR` writes phase 7's tree with phase 8's training split
and phase 9's inputs (and their configs) on the CPU and stops: the JAX
package's `test`, `vivo` and `score-bop` commands run on it for the
reference recall and AR.

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
# the training phase: its split of the tree, the command's steps and log
# cadence (3 log steps: 3 rolling checkpoints, 3 pose validations), the
# batch of the card-vs-CPU step check
TRAIN_FRAMES, TRAIN_SEED = 160, 4
TRAIN_STEPS, TRAIN_LOG_FREQ, TRAIN_BATCH = 300, 100, 32
STEP_CHECK_BATCH = 8
# ADD recall@0.1d of the JAX package on that tree: `python -m
# zebrapose_tpu test --batch_size 32` (and `--escalate_h 256`) with
# JAX_PLATFORMS=cpu, JAX 0.9.0 on an x86 host's CPU. The card's recall
# must reach each less RECALL_SLACK.
JAX_CPU_RECALL = {"plain": 0.7833333333333333,
                  "escalated": 0.7833333333333333}
RECALL_SLACK = 0.10
# the BOP-challenge phase: its detections' seed, the vivo batch, and the
# JAX package's BOP19 scores on the same tree: `python -m zebrapose_tpu
# vivo --cfg DIR/lmo_ape_vivo.txt --obj_name ape --ckpt_file
# trained/rehearsal3_best.npz --batch_size 32`, then `python -m
# zebrapose_tpu score-bop --csv <its CSV> --bop_path DIR --dataset lmo`,
# with JAX_PLATFORMS=cpu, JAX 0.9.0 on an x86 host's CPU over
# `--write-tree DIR` (190 instances, 160 solved).
# The card's AR must reach it less AR_SLACK.
VIVO_SEED, VIVO_BATCH = 6, 32
JAX_CPU_BOP = {"AR": 0.8901111111111111, "AR_vsd": 0.8478333333333333,
               "AR_mssd": 0.8441666666666666, "AR_mspd": 0.9783333333333333}
AR_SLACK = 0.10
# the data-preparation phase: the committed image fixtures (their cv2
# decodes in manifest.json), the SHA-256 of the label ids of the JAX
# package's `python -m zebrapose_tpu generate-labels --cfg DIR/lmo_ape.txt
# --obj_name ape --data_folder test` over `--write-tree DIR`
# (JAX_PLATFORMS=cpu, its native library built by g++ 12.2.0 on an x86
# host; `label_ids_sha` of its test_GT_v2/000001 read with cv2), without a
# symmetry and with the sphere's continuous symmetry about z in
# models/models_info.json; the training command's steps and batch
FIXTURES = os.path.join(HERE, "tests", "data", "torch_images")
JAX_CPU_LABELS = {
    "plain": "17d21f769c1c5cd5c9558c1f882d3dc8f1ca69e6ee5bddb6898169562126f245",
    "continuous_z":
        "327cd88fedcaa803dc60ceabe092739d344f0485f159082384ecd3987244c30c"}
SYM_INFO = {"symmetries_continuous": [{"axis": [0, 0, 1],
                                       "offset": [0, 0, 0]}]}
PREP_FRAMES, PREP_STEPS, PREP_BATCH = 4, 40, 32

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


def busy_share(fn, steps):
    """(share of the wall the device spent in kernels, kernels a step)
    over one call of `fn` (`steps` steps) under torch.profiler, from a
    drained device to a drained device; (None, 0) when the profiler sees
    no device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not kern:
        return None, 0
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    return busy / wall, sum(e.count for e in kern) / steps


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


def pixel_rays(offset=0.0):
    """[480 * 640, 3] rays K^-1 (x + offset, y + offset, 1) of every
    pixel, row-major (offset 0.5: through the pixel centres, the
    rasterizer's convention)."""
    ys, xs = np.mgrid[0:480, 0:640] + offset
    return np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3) @ \
        np.linalg.inv(K_LMO.astype(np.float64)).T


def sphere_hits(rays, t):
    """Which rays hit the rehearsal sphere centred at camera point t,
    and the ray parameter of each first hit ([P] bool, [P]; the depth in
    mm, since the rays have z = 1; meaningless where a ray misses)."""
    rr = (rays * rays).sum(-1)
    dt = rays @ t
    disc = dt * dt - rr * (t @ t - SPHERE_RADIUS ** 2)
    hit = disc >= 0
    return hit, (dt - np.sqrt(np.where(hit, disc, 0))) / rr


def sphere_surface(rays, R, t):
    """Which rays hit the rehearsal sphere at pose (R, t), and each
    ray's first surface point in the model frame ([P] bool, [P, 3];
    the points of missing rays are meaningless)."""
    hit, s = sphere_hits(rays, t)
    return hit, (s[:, None] * rays - t) @ R


def sphere_frame(rng, rays):
    """One 480x640 BGR frame of the rehearsal object (a radius-40 sphere
    whose color codes its surface position) at a random pose over random
    background with pixel noise: frame, hit mask [480, 640], the rays'
    model-frame surface points [P, 3], bbox (x, y, w, h of the hit
    mask), R [3, 3], t [3] (camera point = R · model point + t)."""
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R *= np.sign(np.linalg.det(R))
    t = np.array([rng.uniform(-40, 40), rng.uniform(-30, 30),
                  rng.uniform(480, 650)])
    hit, pm = sphere_surface(rays, R, t)
    color = (pm / SPHERE_RADIUS * 0.5 + 0.5) * 255
    bg = rng.integers(0, 255, (480 * 640, 3))
    img = np.where(hit[:, None], color, bg) + rng.normal(
        0, 6, (480 * 640, 3))
    frame = np.clip(img, 0, 255).astype(np.uint8).reshape(480, 640, 3)
    hy, hx = np.nonzero(hit.reshape(480, 640))
    bbox = [hx.min(), hy.min(), hx.max() - hx.min() + 1,
            hy.max() - hy.min() + 1]
    return frame, hit.reshape(480, 640), pm, bbox, R, t


def sphere_frames(B, rng):
    """B frames of `sphere_frame`, drawn in turn from `rng`; returns
    frames, bboxes [B, 4], hit masks [B, 480, 640] and poses (R [B, 3,
    3], t [B, 3])."""
    rays = pixel_rays()
    frames = np.empty((B, 480, 640, 3), np.uint8)
    hits = np.empty((B, 480, 640), bool)
    bboxes, Rs, ts = [], [], []
    for b in range(B):
        frames[b], hits[b], _, bbox, R, t = sphere_frame(rng, rays)
        bboxes.append(bbox)
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
    hit mask, depth (`write_depth`), scene_camera / scene_gt /
    scene_gt_info, the UV-sphere mesh (diameter 80), camera.json, the
    committed rehearsal LUT as
    `models_GT_color/Class_CorresPoint000001.txt`, a config file
    `<root>/lmo_ape.txt`, and the BOP-challenge phase's targets,
    detections and config (`write_vivo_inputs`). Returns (config path,
    rgb frames, masks)."""
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
    write_depth(scene, ts)
    cfg_path = os.path.join(root, "lmo_ape.txt")
    with open(cfg_path, "w") as f:
        f.write(f"bop_path = {root}\ndataset_name = lmo\n"
                "test_folder = test\nBoundingBox_CropSize_image = 256\n"
                "BoundingBox_CropSize_GT = 128\n"
                "divide_number_each_itration = 2\n"
                "number_of_itration = 16\n")
    write_vivo_inputs(root, bboxes)
    return cfg_path, frames, masks


def write_depth(scene, ts):
    """`depth/{im:06d}.png` of each frame: the analytic depth of the
    sphere centred at ts[im] at the pixel centres (the rasterizer's
    convention), uint16 mm rounded, depth_scale 1.0 as LM-O ships it; 0
    where the ray misses."""
    from zebrapose_tpu_torch.data import png

    os.makedirs(os.path.join(scene, "depth"), exist_ok=True)
    rays = pixel_rays(0.5)
    for im, t in enumerate(ts):
        hit, z = sphere_hits(rays, t)
        depth = np.where(hit, np.round(z), 0).astype(np.uint16)
        png.imwrite(os.path.join(scene, "depth", f"{im:06d}.png"),
                    depth.reshape(480, 640))


def vivo_detections(bboxes, seed=VIVO_SEED):
    """Detections of the tree's frames as a detector's JSON would give
    them ({"1/im": [{obj_id, bbox_est, score}]}, file order kept): every
    frame a box within 3 px of its GT bbox at 0.9; every 3rd frame that
    box scaled 1.2x about its centre at 0.5; every 4th a box of its size
    in the image half away from the object at 0.3; every 5th a box at
    0.1, below the vivo threshold of 0.2."""
    rng = np.random.default_rng(seed)
    dets = {}
    for im, (x, y, w, h) in enumerate(np.asarray(bboxes, np.int64)):
        near = [int(v) for v in np.array([x, y, w, h])
                + rng.integers(-3, 4, 4)]
        out = [{"obj_id": 1, "bbox_est": near, "score": 0.9}]
        if im % 3 == 0:
            cx, cy = near[0] + near[2] / 2, near[1] + near[3] / 2
            ww, hh = 1.2 * near[2], 1.2 * near[3]
            out.append({"obj_id": 1, "score": 0.5, "bbox_est": [
                int(round(cx - ww / 2)), int(round(cy - hh / 2)),
                int(round(ww)), int(round(hh))]})
        if im % 4 == 0:
            bx = int(rng.integers(380, 640 - w)) if x + w / 2 < 320 \
                else int(rng.integers(0, 260 - w))
            out.append({"obj_id": 1, "score": 0.3, "bbox_est": [
                bx, int(rng.integers(0, 480 - h)), int(w), int(h)]})
        if im % 5 == 0:
            out.append({"obj_id": 1, "score": 0.1, "bbox_est": [
                int(v) for v in rng.integers(0, 200, 4) + [0, 0, 20, 20]]})
        dets[f"1/{im}"] = out
    return dets


def write_vivo_inputs(root, bboxes):
    """The BOP-challenge phase's inputs in the tree under `root`:
    `lmo/test_targets_bop19.json` (inst_count 1 an image),
    `<root>/detections_vivo.json` (`vivo_detections` of the GT bboxes)
    and the config `<root>/lmo_ape_vivo.txt` (lmo_ape.txt's keys and
    Detection_reaults)."""
    with open(os.path.join(root, "lmo", "test_targets_bop19.json"),
              "w") as f:
        json.dump([{"scene_id": 1, "im_id": im, "obj_id": 1,
                    "inst_count": 1} for im in range(len(bboxes))], f)
    det_path = os.path.join(root, "detections_vivo.json")
    with open(det_path, "w") as f:
        json.dump(vivo_detections(bboxes), f)
    with open(os.path.join(root, "lmo_ape.txt")) as f:
        base = f.read()
    with open(os.path.join(root, "lmo_ape_vivo.txt"), "w") as f:
        f.write(base + f"Detection_reaults = {det_path}\n")


def write_train_split(root, n_frames=TRAIN_FRAMES, seed=TRAIN_SEED):
    """Write the training phase's split into the tree under `root`
    (after `write_tree`): `lmo/train_real/000001` with `n_frames` sphere
    frames (frame i from default_rng([seed, i])), their rows written with the Sub filter (the one
    `cv2.imwrite` picks), masks, scene_camera / scene_gt /
    scene_gt_info, and GT labels in `lmo/train_real_GT_v2/000001`. A hit
    pixel's label is the class whose committed LUT centroid lies nearest
    to the pixel's model-frame surface point: the LUT's Voronoi cells,
    from the analytic surface points, which phase 8 has always trained
    on (phase 10 labels its split with the port's `generate-labels`,
    the partitioner's faces rendered). Also writes the config
    `<root>/lmo_ape_train.txt`. Returns its path."""
    import torch
    from scipy.spatial import cKDTree

    from zebrapose_tpu_torch.codec.surface_code import class_id_to_rgb
    from zebrapose_tpu_torch.data import png

    from concurrent.futures import ThreadPoolExecutor

    with np.load(LUT) as z:
        ids = np.flatnonzero(z["valid"])
        cells = cKDTree(z["points"][ids].astype(np.float64))
    ds = os.path.join(root, "lmo")
    scene = os.path.join(ds, "train_real", "000001")
    gt_dir = os.path.join(ds, "train_real_GT_v2", "000001")
    for d in (os.path.join(scene, "rgb"), os.path.join(scene, "mask"),
              os.path.join(scene, "mask_visib"), gt_dir):
        os.makedirs(d, exist_ok=True)
    rays = pixel_rays()

    def write_frame(im):
        # one generator a frame, so the frames render on a thread pool
        frame, hit, pm, bbox, R, t = sphere_frame(
            np.random.default_rng([seed, im]), rays)
        png.imwrite(os.path.join(scene, "rgb", f"{im:06d}.png"), frame,
                    filters=1)
        mask = hit.astype(np.uint8) * 255
        for sub in ("mask", "mask_visib"):
            png.imwrite(os.path.join(scene, sub, f"{im:06d}_000000.png"), mask)
        cls = np.zeros(480 * 640, np.int64)
        on = hit.reshape(-1)
        cls[on] = ids[cells.query(pm[on])[1]]
        label = class_id_to_rgb(torch.from_numpy(cls.reshape(480, 640)))
        png.imwrite(os.path.join(gt_dir, f"{im:06d}_000000.png"),
                    label.numpy(), filters=1)
        return bbox, R, t

    with ThreadPoolExecutor(max_workers=8) as pool:
        poses = list(pool.map(write_frame, range(n_frames)))
    cam, gt, gti = {}, {}, {}
    for im, (bbox, R, t) in enumerate(poses):
        cam[str(im)] = {"cam_K": K_LMO.reshape(-1).tolist(),
                        "depth_scale": 1.0}
        gt[str(im)] = [{"cam_R_m2c": R.reshape(-1).tolist(),
                        "cam_t_m2c": t.tolist(), "obj_id": 1}]
        gti[str(im)] = [{"bbox_visib": [int(v) for v in bbox],
                         "visib_fract": 1.0}]
    for name, obj in (("scene_camera", cam), ("scene_gt", gt),
                      ("scene_gt_info", gti)):
        with open(os.path.join(scene, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    cfg_path = os.path.join(root, "lmo_ape_train.txt")
    with open(os.path.join(root, "lmo_ape.txt")) as f:
        base = f.read()
    with open(cfg_path, "w") as f:
        f.write(base + "training_data_folder = train_real\n"
                "val_folder = test\n"
                f"batch_size = {TRAIN_BATCH}\nlearning_rate = 2e-4\n")
    return cfg_path


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


class _Batches:
    """Batches collated once, served in turn from memory (a train
    iterator for timing the step without the host's reads)."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def __next__(self):
        self.i += 1
        return self.batches[(self.i - 1) % len(self.batches)]

    def close(self):
        pass


def _metrics_rows(run):
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def step_check(dev, card, cfg, root):
    """Phase 8, item 2: one training step on the card against the CPU
    from the committed weights, on the same batch (jittered crops of the
    training split) and the same injected augmentation, float32 with
    TF32 off, from a carried histogram EMA (a code bit that flips between
    the two changes it by 0.05 / (mask pixels + 1))."""
    import torch

    from zebrapose_tpu_torch.data import bop_io
    from zebrapose_tpu_torch.data.pipeline import (
        CropDatasetHost,
        preprocess_batch,
    )
    from zebrapose_tpu_torch.models.convert import variables_to_state_dict
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu_torch.ops.augment import draw_augment
    from zebrapose_tpu_torch.train import trainer
    from zebrapose_tpu_torch.train.state import create_train_state
    from zebrapose_tpu_torch.train.train_step import train_step
    from zebrapose_tpu_torch.utils.compact_ckpt import load_compact

    n = STEP_CHECK_BATCH
    samples = bop_io.get_dataset(root, "lmo", train=True,
                                 data_folder="train_real")
    ds = CropDatasetHost(samples.dataset_dir, "train_real",
                         *samples.for_obj(1), is_train=True)
    raw = ds.collate(list(range(n)))
    sd = variables_to_state_dict(load_compact(CKPT)[0], "v2")
    draws = draw_augment(torch.Generator().manual_seed(12), n, 256, 256)
    hist0 = torch.linspace(0.02, 0.45, 16)
    got = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for d in (dev, torch.device("cpu")):
            model = ZebraPoseNet(binary_code_length=16, variant="v2")
            model.load_state_dict(sd, strict=True)
            model = model.to(d).to(memory_format=torch.channels_last)
            state = create_train_state(model, cfg.learning_rate, n_bits=16)
            state.histogram = hist0.to(d)
            batch = preprocess_batch(
                {k: torch.as_tensor(raw[k]).to(d) for k in
                 trainer._FEED_KEYS}, crop_img=256, crop_gt=128,
                is_train=True, draws=draws.to(d))
            t0 = time.perf_counter()
            m = train_step(state, batch, trainer._loss_cfg(cfg),
                           binary_loss_weight=float(cfg.binary_loss_weight),
                           predict_entire_mask=cfg.predict_entire_mask)
            m = {k: float(v) for k, v in m.items()}
            secs = time.perf_counter() - t0
            stats = {k: v.cpu() for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            got[d.type] = (m, stats, state.histogram.cpu(), secs)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    (mc, sc, hc, tc), (mp, sp, hp, tp) = got[dev.type], got["cpu"]
    rel = {k: abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-12)
           for k in ("loss_total", "grad_norm")}
    bn_err = max(float(((sc[k] - sp[k]).abs()
                        / sp[k].abs().clamp(min=1.0)).max()) for k in sp)
    hist_err = float((hc - hp).abs().max())
    log(f"[train] one b{n} step, card vs CPU (f32, TF32 off, the committed "
        f"weights, injected augmentation): loss_total {mc['loss_total']:.6f}"
        f" vs {mp['loss_total']:.6f} (rel {rel['loss_total']:.2e}), "
        f"grad_norm {mc['grad_norm']:.6f} vs {mp['grad_norm']:.6f} (rel "
        f"{rel['grad_norm']:.2e}); BN running statistics max err "
        f"{bn_err:.2e} (relative to max(1, |value|)) over {len(sp)} "
        f"tensors; histogram max err {hist_err:.2e}; the step took "
        f"{tc:.2f} s on the card (first, with cuDNN's search) and "
        f"{tp:.2f} s on the CPU, on {card}")
    check(rel["loss_total"] <= 1e-3 and rel["grad_norm"] <= 1e-3,
          "train step: loss or grad_norm differ between card and CPU")
    check(bn_err <= 1e-4, "train step: BN running statistics differ")
    check(hist_err <= 1e-5, "train step: histograms differ")
    return {"batch": n, "rel": rel, "bn_err": bn_err, "hist_err": hist_err,
            "card_s": tc, "cpu_s": tp}


def train_phase(dev, card, tmp):
    """Phase 8 (see the module docstring), after phase 7 wrote its tree
    under `tmp`; returns its record."""
    import torch

    from zebrapose_tpu_torch import cli
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses
    from zebrapose_tpu_torch.train import trainer

    root = os.path.join(tmp, "bop")
    t_phase = t0 = time.perf_counter()
    cfg_path = write_train_split(root)
    log(f"[train] split of {TRAIN_FRAMES} frames with GT labels written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = ZebraConfig.from_file(cfg_path)
    rec = {"card": card, "frames": TRAIN_FRAMES, "batch": TRAIN_BATCH,
           "steps": TRAIN_STEPS, "log_freq": TRAIN_LOG_FREQ,
           "step_check": step_check(dev, card, cfg, root)}

    # the command: from scratch, bf16, frames cached, pose validation
    out = os.path.join(tmp, "runs")
    run = os.path.join(out, "lmo_ape")
    args = ["train", "--cfg", cfg_path, "--obj_name", "ape",
            "--from_scratch", "--bf16", "--cache_images", "--log_freq",
            str(TRAIN_LOG_FREQ), "--output_dir", out, "--device", str(dev)]
    minimal_epnp_hypotheses.launches = 0          # the training path's run
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    rc = cli.main(args + ["--max_steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = minimal_epnp_hypotheses.launches
    peak = torch.cuda.max_memory_allocated(dev)
    check(rc == 0, f"train returned {rc}")
    rows = _metrics_rows(run)
    losses = [r["value"] for r in rows
              if r["tag"] == "train/step_loss_total"]
    check(len(losses) == TRAIN_STEPS, "not every step's loss was logged")
    check(all(np.isfinite(r["value"]) for r in rows
              if r["tag"].startswith("train/")), "a logged loss is not finite")
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    recalls = [r["value"] for r in rows if r["tag"] == "val/ADD_recall_0.1d"]
    timing = {r["tag"][len("timing/"):]: r["value"] for r in rows
              if r["tag"].startswith("timing/")}
    n_val = len(recalls)
    val_batches = -(-TREE_FRAMES // 16)
    steps_dir = os.path.join(run, "checkpoints", "steps")
    best_dir = os.path.join(run, "checkpoints", "best")
    rolling = sorted(os.listdir(steps_dir))
    best = sorted(f for f in os.listdir(best_dir) if f.endswith(".pth")) \
        if os.path.isdir(best_dir) else []
    train_s = timing["fit_s"] - timing["val_s"] - timing["log_s"]
    step_ms = 1e3 * train_s / timing["steps"]
    log(f"[train] `train --from_scratch --bf16 --cache_images`, b"
        f"{TRAIN_BATCH}, {TRAIN_STEPS} steps: loss_total mean of the first "
        f"20 steps {first:.4f}, of the last 20 {last:.4f} (ratio "
        f"{last / first:.3f}); val ADD recall@0.1d at steps "
        f"{', '.join(str(TRAIN_LOG_FREQ * (i + 1)) for i in range(n_val))}: "
        f"{', '.join(f'{r:.4f}' for r in recalls)}; {launches} kernel "
        f"launches in validation ({n_val} x {val_batches} batches of 16); "
        f"rolling {rolling}, best {best}; on {card}")
    log(f"[train] in the command ({wall:.1f} s wall, fit {timing['fit_s']:.1f}"
        f" s): {step_ms:.1f} ms a step ({TRAIN_BATCH / step_ms * 1e3:.1f} "
        f"samples/s) over the steps' share; waiting for a batch "
        f"{timing['wait_s']:.2f} s ({100 * timing['wait_s'] / timing['fit_s']:.1f}"
        f"% of fit, {100 * timing['wait_s'] / train_s:.1f}% of the steps' "
        f"share); issuing steps {timing['step_s']:.2f} s; logs and "
        f"checkpoint copies {timing['log_s']:.2f} s; validation "
        f"{timing['val_s']:.2f} s ({timing['val_s'] / max(n_val, 1):.2f} s "
        f"each over {TREE_FRAMES} frames); peak device memory "
        f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); on {card}")
    check(last < first, "the loss did not fall")
    check(n_val >= 2, "pose validation ran fewer than twice")
    check(launches >= n_val * val_batches,
          "validation did not launch the EPnP kernel on every batch")
    check(len(rolling) == 3, "not 3 rolling checkpoints")
    check(len(best) == 1 or max(recalls) == 0.0,
          "a validation raised recall but no best checkpoint was kept")
    rec.update(wall_s=wall, launches=launches, losses_first20=first,
               losses_last20=last, recalls=recalls, timing=timing,
               step_ms=step_ms, peak_bytes=peak, rolling=rolling, best=best)

    # `test` loads the best checkpoint strictly (the newest rolling one
    # when no validation rose above recall 0)
    if best:
        ckpt = os.path.join(best_dir, best[0])
    else:
        log("[train] no validation rose above recall 0: no best "
            "checkpoint; `test` takes the newest rolling one")
        ckpt = os.path.join(steps_dir, f"step_{TRAIN_STEPS}.pth")
    test_out = os.path.join(tmp, "test_trained")
    rc = cli.main(["test", "--cfg", os.path.join(root, "lmo_ape.txt"),
                   "--obj_name", "ape", "--ckpt_file", ckpt, "--batch_size",
                   "32", "--output_dir", test_out, "--device", str(dev)])
    check(rc == 0, f"test of the trained checkpoint returned {rc}")
    (run_dir,) = os.listdir(test_out)
    with open(os.path.join(test_out, run_dir, "pose_result_bop",
                           "lmo_ape.csv")) as f:
        n_rows = len(f.read().splitlines()) - 1
    with open(os.path.join(test_out, run_dir, "ADD_result.txt")) as f:
        metrics = {k: float(v) for k, v in
                   (ln.split() for ln in f.read().splitlines())}
    check(n_rows == TREE_FRAMES, f"test wrote {n_rows} CSV rows")
    log(f"[train] `test --ckpt_file {os.path.relpath(ckpt, run)}`: "
        f"{n_rows} CSV rows, ADD recall@0.1d "
        f"{metrics['ADD_recall_0.1d']:.4f} (not gated: {TRAIN_STEPS} steps "
        f"from scratch)")
    rec["test_recall"] = metrics["ADD_recall_0.1d"]

    # resume: load_checkpoint = True, 10 more steps
    resume_cfg = os.path.join(root, "lmo_ape_resume.txt")
    with open(cfg_path) as f, open(resume_cfg, "w") as g:
        g.write(f.read() + "load_checkpoint = True\n")
    args[2] = resume_cfg
    rc = cli.main(args + ["--max_steps", "10"])
    check(rc == 0, f"the resumed train returned {rc}")
    steps = [r["step"] for r in _metrics_rows(run)
             if r["tag"] == "train/step_loss_total"][TRAIN_STEPS:]
    check(steps == list(range(TRAIN_STEPS + 1, TRAIN_STEPS + 11))
          and os.path.exists(os.path.join(
              steps_dir, f"step_{TRAIN_STEPS + 10}.pth")),
          f"the resume ran steps {steps[:1]}..{steps[-1:]}")
    log(f"[train] resumed at step {TRAIN_STEPS}, ran steps {steps[0]}-"
        f"{steps[-1]}, rolling {sorted(os.listdir(steps_dir))}")

    # the step alone: frames collated once and served from memory, bf16
    # and f32 (PyTorch's default TF32: cuDNN on, matmul off); then the
    # stream of frames read and decoded per draw
    rec["timed"] = {}
    for name, bf16, cache in (("bf16", True, True), ("f32", False, True),
                              ("bf16_stream", True, False)):
        res = trainer.build_train_setup(
            cfg, "ape", os.path.join(tmp, f"timed_{name}"),
            pretrained_backbone=None, bf16=bf16, cache_images=cache,
            log_freq=TRAIN_LOG_FREQ, device=dev)
        try:
            if cache:
                batches = [next(res.train_iter) for _ in range(4)]
                res.train_iter.close()
                res.train_iter = _Batches(batches)
            n, warm = (30, 10) if cache else (20, 3)
            torch.cuda.reset_peak_memory_stats(dev)
            t = {}
            trainer.timed_steps(res, n_steps=n, warm=warm, timing=t)
            t["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            t["busy_share"], t["kernels_a_step"] = busy_share(
                lambda: trainer.timed_steps(res, n_steps=5, warm=0), 5)
        finally:
            res.train_iter.close()
            res.ckpt.close()
            res.logger.close()
        wait = t["wait_s"] / (t["host_ms"] * n / 1e3)
        busy = ("not measured (no device kernels seen)"
                if t["busy_share"] is None else
                f"{100 * t['busy_share']:.1f}% ({t['kernels_a_step']:.0f} "
                f"kernels a step)")
        log(f"[train] timed_steps {name} ("
            + ("frames from memory" if cache else
               "frames read per draw, 8 reading threads")
            + f"), b{TRAIN_BATCH}, {n} steps after {warm}: "
            f"{t['host_ms']:.2f} ms a step host clock, "
            f"{t.get('event_ms', float('nan')):.2f} ms CUDA events, "
            f"{TRAIN_BATCH / t['host_ms'] * 1e3:.1f} samples/s; waiting for "
            f"a batch {100 * wait:.1f}% of the time; device busy over 5 "
            f"more steps under torch.profiler {busy}; peak device memory "
            f"{t['peak_bytes'] / 2 ** 30:.2f} GiB; on {card}")
        rec["timed"][name] = dict(t, wait_share=wait)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase 8 took {rec['phase_s']:.1f} s")
    return rec


def _near_thresholds(err, thresholds, tol):
    """[n] bool: which errors lie within `tol` ([n] or scalar) of any of
    `thresholds`."""
    err = np.asarray(err, np.float64)
    return (np.abs(err[:, None] - np.asarray(thresholds)[None])
            <= np.broadcast_to(tol, err.shape)[:, None]).any(1)


def _last_json(text):
    """The JSON object that ends `text` (a command's result, printed
    with json.dumps(indent=2): its first line is "{")."""
    return json.loads(text[text.rfind("\n{\n") + 1:])


def bop_phase(dev, card, tmp):
    """Phase 9 (see the module docstring) over phase 7's tree under
    `tmp`; returns its record."""
    import contextlib
    import io

    import torch

    from zebrapose_tpu_torch import cli
    from zebrapose_tpu_torch.eval import bop_score
    from zebrapose_tpu_torch.native import render_label
    from zebrapose_tpu_torch.ops._build import _cxx
    from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "bop")
    with open(os.path.join(root, "detections_vivo.json")) as f:
        dets = json.load(f)
    # vivo's instance order: images in walk order, detections in file
    # order, those under the threshold dropped
    expected = [(im, d["score"]) for im in range(TREE_FRAMES)
                for d in dets[f"1/{im}"] if d["score"] >= 0.2]
    n_inst = len(expected)
    out = os.path.join(tmp, "out_vivo")
    minimal_epnp_hypotheses.launches = 0        # the vivo path's run
    t0 = time.perf_counter()
    rc = cli.main(["vivo", "--cfg", os.path.join(root, "lmo_ape_vivo.txt"),
                   "--obj_name", "ape", "--ckpt_file", CKPT, "--batch_size",
                   str(VIVO_BATCH), "--output_dir", out, "--device",
                   str(dev)])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = minimal_epnp_hypotheses.launches
    check(rc == 0, f"vivo returned {rc}")
    (run_dir,) = os.listdir(out)
    run_dir = os.path.join(out, run_dir)
    with open(os.path.join(run_dir, "log.txt")) as f:
        log_text = f.read()
    res = _last_json(log_text)
    (timing,) = [json.loads(ln.split(" ", 1)[1]) for ln in
                 log_text.splitlines() if ln.startswith("timing ")]
    batches = -(-n_inst // VIVO_BATCH)
    log(f"[bop] vivo, b{VIVO_BATCH}: {res['instances']} instances of "
        f"{sum(len(v) for v in dets.values())} detections ({n_inst} at "
        f"score >= 0.2), solved {res['solved']} ({res['solve_rate']:.4f}); "
        f"{wall:.2f} s wall, {res['instances'] / wall:.2f} instances/s; "
        f"{launches} kernel launches over {batches} batches; on {card}")
    log("[bop] vivo timing " + json.dumps(timing))
    check(res["instances"] == n_inst, "vivo lost or added instances")
    check(launches == batches, f"vivo launched the kernel {launches} "
          f"times over {batches} batches")
    csv = os.path.join(run_dir, "pose_result_bop", "lmo_ape.csv")
    rows = [ln.split(",") for ln in open(csv).read().splitlines()[1:]]
    got = [(int(r[1]), float(r[3])) for r in rows]
    it = iter(expected)
    check(len(rows) == res["solved"] and all(g in it for g in got)
          and all(r[0] == "1" and r[2] == "1" for r in rows),
          "the CSV does not hold the solved instances in order, each "
          "with its detection's score")

    # score-bop on the card (the command, and the call that also
    # returns each pair's errors and the time split), on the CPU
    args = ["score-bop", "--csv", csv, "--bop_path", root, "--dataset",
            "lmo"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args + ["--device", str(dev)])
    check(rc == 0, f"score-bop returned {rc}")
    command = _last_json(buf.getvalue())
    scores, errs, times = {}, {}, {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        errs[key], times[key] = {}, {}
        scores[key] = bop_score.score_csv(csv, root, "lmo", device=d,
                                          timing=times[key],
                                          pair_errors=errs[key])
    card_s, cpu_s = scores["card"], scores["cpu"]
    check(json.loads(json.dumps(card_s)) == command,
          "score-bop's printed result differs from score_csv's")
    ec, ep = errs["card"][1], errs["cpu"][1]
    n_pairs = len(ep["mssd"])
    rel = {}
    for k in ("mssd", "mspd"):
        d = np.abs(ec[k] - ep[k])
        rel[k] = float((d / np.maximum(np.abs(ep[k]), 1e-12)).max())
        # float32 spacing of a 600 mm coordinate is 6e-5
        check(np.isfinite(ep[k]).all() and (d <= 1e-5 * np.abs(ep[k])
                                             + 1e-4).all(),
              f"{k}: card and CPU differ beyond 1e-5 relative")
    union = ep["vsd_union"].astype(np.float64)
    vsd_d = np.abs(ec["vsd"] - ep["vsd"]).max(1) * np.maximum(union, 1)
    check((ec["vsd_union"] == ep["vsd_union"]).all()
          and (vsd_d <= 1.0 + 1e-3).all(),
          "VSD: card and CPU differ by more than a pixel of the union")
    near = {
        "AR_mssd": _near_thresholds(ep["mssd"], bop_score.THETAS * 80.0,
                                    1e-5 * np.abs(ep["mssd"]) + 1e-4),
        "AR_mspd": _near_thresholds(ep["mspd"], bop_score.MSPD_THETAS,
                                    1e-5 * np.abs(ep["mspd"]) + 1e-4),
        "AR_vsd": np.array([_near_thresholds(
            row, bop_score.THETAS, 1.0 / max(u, 1)).any()
            for row, u in zip(ep["vsd"], union)], bool)}
    n_gt = card_s["n_targets"]
    for k, flags in near.items():
        check(abs(card_s[k] - cpu_s[k]) <= flags.sum() / n_gt,
              f"{k}: card {card_s[k]} vs CPU {cpu_s[k]} beyond the "
              f"{int(flags.sum())} pairs near a threshold")
    log(f"[bop] score-bop, S = 1: card AR {card_s['AR']:.4f} (vsd "
        f"{card_s['AR_vsd']:.4f}, mssd {card_s['AR_mssd']:.4f}, mspd "
        f"{card_s['AR_mspd']:.4f}), CPU AR {cpu_s['AR']:.4f} (vsd "
        f"{cpu_s['AR_vsd']:.4f}, mssd {cpu_s['AR_mssd']:.4f}, mspd "
        f"{cpu_s['AR_mspd']:.4f}) over {n_gt} targets and {n_pairs} pairs; "
        f"card vs CPU per pair: mssd rel {rel['mssd']:.2e}, mspd rel "
        f"{rel['mspd']:.2e}, VSD max {vsd_d.max():.3f} union pixels; pairs "
        "within the tolerance of a threshold: "
        + ", ".join(f"{k[3:]} {int(v.sum())}" for k, v in near.items()))
    want = JAX_CPU_BOP["AR"] - AR_SLACK
    log(f"[bop] the JAX package on a CPU, same tree: AR "
        f"{JAX_CPU_BOP['AR']:.4f} (vsd {JAX_CPU_BOP['AR_vsd']:.4f}, mssd "
        f"{JAX_CPU_BOP['AR_mssd']:.4f}, mspd {JAX_CPU_BOP['AR_mspd']:.4f}); "
        f"gate card AR >= {want:.4f}")
    check(card_s["AR"] >= want, f"AR below the JAX package's less {AR_SLACK}")

    # the sphere's continuous symmetry about z: ceil(pi / 0.01) - 1 = 314
    # rotations (bop_toolkit's discretization leaves out the angle 0)
    info_path = os.path.join(root, "lmo", "models_eval", "models_info.json")
    with open(info_path) as f:
        info = f.read()
    sym = json.loads(info)
    sym["1"]["symmetries_continuous"] = [{"axis": [0, 0, 1],
                                          "offset": [0, 0, 0]}]
    n_sym = len(bop_score.get_symmetry_transformations(sym["1"])[0])
    with open(info_path, "w") as f:
        json.dump(sym, f)
    try:
        times["card_sym"] = {}
        sym_s = bop_score.score_csv(csv, root, "lmo", device=dev,
                                    timing=times["card_sym"])
    finally:
        with open(info_path, "w") as f:
            f.write(info)
    log(f"[bop] score-bop, S = {n_sym} (continuous symmetry about z): card "
        f"AR {sym_s['AR']:.4f} (vsd {sym_s['AR_vsd']:.4f}, mssd "
        f"{sym_s['AR_mssd']:.4f}, mspd {sym_s['AR_mspd']:.4f})")
    check(n_sym == 314, f"{n_sym} symmetry transforms, not 314")
    check(sym_s["AR_mssd"] >= card_s["AR_mssd"]
          and sym_s["AR_mspd"] >= card_s["AR_mspd"]
          and sym_s["AR_vsd"] == card_s["AR_vsd"],
          "the symmetry lowered AR_mssd / AR_mspd or moved AR_vsd")
    for key, what in (("card", f"S = 1 on {card}"), ("cpu", "S = 1 on the "
                      "card machine's CPU"), ("card_sym",
                                              f"S = {n_sym} on {card}")):
        t = times[key]
        log(f"[bop] score-bop {what}: {t['score_s']:.2f} s: errors "
            f"{t['errors_s']:.2f} s (device), depth renders "
            f"{t['render_s']:.2f} s (host), VSD pixel math {t['vsd_s']:.2f}"
            f" s (device), matching {t['match_s']:.2f} s (host)")

    # the host rasterizer, built here, against the written analytic
    # depth of frame 0
    from zebrapose_tpu_torch.data import bop_io, png
    mesh = bop_io.load_ply(os.path.join(root, "lmo", "models_eval",
                                        "obj_000001.ply"))
    with open(os.path.join(root, "lmo", "test", "000001",
                           "scene_gt.json")) as f:
        g = json.load(f)["0"][0]
    _, rendered = render_label(
        mesh["pts"], mesh["faces"], np.ones(len(mesh["faces"]), np.int32),
        K_LMO, np.array(g["cam_R_m2c"]).reshape(3, 3),
        np.array(g["cam_t_m2c"]), 640, 480, with_depth=True)
    written = png.imread(os.path.join(root, "lmo", "test", "000001",
                                      "depth", "000000.png"),
                         png.IMREAD_UNCHANGED).astype(np.float64)
    both = (rendered > 0) & (written > 0)
    close = float((np.abs(rendered - written)[both] <= 1.0).mean())
    cxx = subprocess.run([_cxx(), "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    log(f"[bop] host rasterizer ({cxx}): frame 0's render within 1 mm of "
        f"the analytic depth on {100 * close:.2f}% of the {int(both.sum())}"
        " pixels both cover")
    check(both.sum() > 1000 and close >= 0.99,
          "the rasterizer disagrees with the analytic depth")
    phase_s = time.perf_counter() - t_phase
    log(f"[bop] phase 9 took {phase_s:.1f} s")
    return {"card": card, "instances": n_inst, "solved": res["solved"],
            "wall_s": wall, "instances_per_s": n_inst / wall,
            "launches": launches, "timing": timing, "scores": scores,
            "scores_sym": sym_s, "n_sym": n_sym, "score_timing": times,
            "rel_err": rel, "vsd_max_union_px": float(vsd_d.max()),
            "near_threshold": {k: int(v.sum()) for k, v in near.items()},
            "render_close_share": close, "cxx": cxx, "phase_s": phase_s}


def label_ids_sha(folder, imread):
    """SHA-256 over a label folder: each file in name order, its name's
    bytes, then its ids (B << 16 | G << 8 | R) as uint32 from `imread`."""
    h = hashlib.sha256()
    for name in sorted(os.listdir(folder)):
        bgr = imread(os.path.join(folder, name)).astype(np.uint32)
        h.update(name.encode())
        h.update(((bgr[..., 0] << 16) | (bgr[..., 1] << 8)
                  | bgr[..., 2]).tobytes())
    return h.hexdigest()


def write_pbr_split(root):
    """A `lmo/train_pbr/000001` split in the tree under `root`: rgb = the
    committed .jpg fixtures (frames 0-3 of `write_train_split`'s
    generator), masks, scene_camera / scene_gt / scene_gt_info from the
    same seeds, no labels; and the config `<root>/lmo_ape_pbr.txt`.
    Returns its path."""
    import shutil

    from zebrapose_tpu_torch.data import png

    scene = os.path.join(root, "lmo", "train_pbr", "000001")
    for sub in ("rgb", "mask", "mask_visib"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    rays = pixel_rays()
    cam, gt, gti = {}, {}, {}
    for im in range(PREP_FRAMES):
        _, hit, _, bbox, R, t = sphere_frame(
            np.random.default_rng([TRAIN_SEED, im]), rays)
        shutil.copy(os.path.join(FIXTURES, f"frame_{im:06d}.jpg"),
                    os.path.join(scene, "rgb", f"{im:06d}.jpg"))
        for sub in ("mask", "mask_visib"):
            png.imwrite(os.path.join(scene, sub, f"{im:06d}_000000.png"),
                        hit.astype(np.uint8) * 255)
        cam[str(im)] = {"cam_K": K_LMO.reshape(-1).tolist(),
                        "depth_scale": 1.0}
        gt[str(im)] = [{"cam_R_m2c": R.reshape(-1).tolist(),
                        "cam_t_m2c": t.tolist(), "obj_id": 1}]
        gti[str(im)] = [{"bbox_visib": [int(v) for v in bbox],
                         "visib_fract": 1.0}]
    for name, obj in (("scene_camera", cam), ("scene_gt", gt),
                      ("scene_gt_info", gti)):
        with open(os.path.join(scene, f"{name}.json"), "w") as f:
            json.dump(obj, f)
    cfg_path = os.path.join(root, "lmo_ape_pbr.txt")
    with open(os.path.join(root, "lmo_ape.txt")) as f:
        base = f.read()
    with open(cfg_path, "w") as f:
        f.write(base + "training_data_folder = train_pbr\n"
                "val_folder = test\n"
                f"batch_size = {PREP_BATCH}\nlearning_rate = 2e-4\n")
    return cfg_path


def _partition_invariants(pts, faces):
    """The partition of the sphere by this machine's build: (whether
    every class holds floor or ceil of V / 2^16 vertices, whether the
    face classes follow the majority rule)."""
    from zebrapose_tpu_torch import native

    vc = native.partition_mesh(pts, 2, 16, seed=0)
    counts = np.bincount(vc, minlength=2 ** 16)
    lo = len(pts) // 2 ** 16
    balanced = bool(counts.min() >= lo and counts.max() <= -(-len(pts)
                                                              // 2 ** 16))
    a, b, c = (vc[faces[:, k]] for k in range(3))
    rule = np.where((a == b) | (a == c), a, np.where(b == c, b, a))
    return balanced, bool((native.face_classes(vc, faces) == rule).all())


def prep_phase(dev, card, tmp, png_ms):
    """Phase 10 (see the module docstring) over phase 7's tree under
    `tmp`; `png_ms` is phase 7's PNG decode ms by row filter. Returns
    its record."""
    import torch

    import shutil

    from zebrapose_tpu_torch import cli
    from zebrapose_tpu_torch.codec.lut import load_correspondence_lut
    from zebrapose_tpu_torch.data import bop_io, png
    from zebrapose_tpu_torch.ops._build import _cxx
    from zebrapose_tpu_torch.ops.pnp_kernel import minimal_epnp_hypotheses

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "bop")
    rec = {"card": card}

    # 1. the committed fixtures against cv2's decodes
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    flags = {"color": png.IMREAD_COLOR, "gray": png.IMREAD_GRAYSCALE,
             "unchanged": png.IMREAD_UNCHANGED}
    equal = 0
    for name, want in sorted(manifest.items()):
        path = os.path.join(FIXTURES, name)
        if "raises" in want:
            try:
                png.imread(path)
                raised = ""
            except NotImplementedError as e:
                raised = str(e)
            check(want["raises"] in raised, f"{name}: not refused by name")
            continue
        for key, flag in flags.items():
            a = np.ascontiguousarray(png.imread(path, flag))
            got = {"shape": list(a.shape), "dtype": str(a.dtype),
                   "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
            check(got == want[key], f"{name} under {key}: {got} is not "
                  f"cv2's {want[key]}")
            equal += 1
    frame = os.path.join(FIXTURES, "frame_000000.jpg")
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        png.imread(frame)
        times.append((time.perf_counter() - t0) * 1e3)
    jpg_ms = float(np.median(times))
    log(f"[prep] {len(manifest)} fixtures: {equal} decodes equal to cv2's "
        f"(COLOR / GRAYSCALE / UNCHANGED), the progressive file refused by "
        f"name; one 480x640 .jpg frame {jpg_ms:.2f} ms (median of 20 reads; "
        "phase 7's PNG ms by row filter: " + ", ".join(
            f"{k} {v:.1f}" for k, v in png_ms.items()) + ") on the card "
        "machine's host")
    rec.update(fixtures_equal=equal, jpg_ms=jpg_ms, png_ms=png_ms)

    # 2. generate-mesh-code on the sphere against the committed LUT
    pts, faces = uv_sphere()
    ply = os.path.join(tmp, "sphere.ply")
    bop_io.save_ply(ply, pts, faces=faces)
    txt = os.path.join(tmp, "sphere_lut.txt")
    t0 = time.perf_counter()
    rc = cli.main(["generate-mesh-code", "--mesh", ply, "-d", "2", "-n",
                   "16", "--corres_txt", txt])
    partition_s = time.perf_counter() - t0
    check(rc == 0, f"generate-mesh-code returned {rc}")
    lut = load_correspondence_lut(txt)
    with np.load(LUT) as z, open(txt, "rb") as f:
        same = (np.array_equal(z["points"], lut.points)
                and np.array_equal(z["valid"], lut.valid)
                and hashlib.sha256(f.read()).hexdigest()
                == str(z["text_sha256"]))
        moved = int((np.abs(z["points"] - lut.points) > 0).any(1).sum())
    cxx = subprocess.run([_cxx(), "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    if same:
        log(f"[prep] generate-mesh-code (70200 vertices, 139860 faces, "
            f"d=2, n=16, seed 0) in {partition_s:.2f} s ({cxx}): points, "
            "valid and text equal to the committed LUT (JAX package, "
            "g++ 12.2.0)")
    else:
        balanced, majority = _partition_invariants(pts, faces)
        log(f"[prep] generate-mesh-code in {partition_s:.2f} s ({cxx}): "
            f"the partition DIFFERS from the committed LUT's (g++ 12.2.0): "
            f"{moved} of 65536 class centroids differ; invariants: every "
            f"class holds floor/ceil(V/2^16) vertices {balanced}, face "
            f"classes by the majority rule {majority}")
        check(balanced and majority, "the partition breaks its invariants")
    rec.update(partition_s=partition_s, lut_equal=same,
               centroids_moved=moved, cxx=cxx)

    # 3. generate-labels over phase 7's split, plain and symmetric
    info_path = os.path.join(root, "lmo", "models", "models_info.json")
    with open(info_path) as f:
        info = f.read()
    labels = os.path.join(root, "lmo", "test_GT_v2")
    cfg_test = os.path.join(root, "lmo_ape.txt")
    rec["labels"] = {}
    try:
        for key in ("plain", "continuous_z"):
            if key == "continuous_z":
                with open(info_path, "w") as f:
                    json.dump({"1": dict(json.loads(info)["1"], **SYM_INFO)},
                              f)
            shutil.rmtree(labels, ignore_errors=True)
            t0 = time.perf_counter()
            rc = cli.main(["generate-labels", "--cfg", cfg_test, "--obj_name",
                           "ape", "--data_folder", "test"])
            secs = time.perf_counter() - t0
            check(rc == 0, f"generate-labels ({key}) returned {rc}")
            folder = os.path.join(labels, "000001")
            n = len(os.listdir(folder))
            sha = label_ids_sha(folder, png.imread)
            ok = sha == JAX_CPU_LABELS[key]
            differ, fg = 0, 0
            if not ok and key == "continuous_z":
                differ, fg, ref_ok = _symmetric_label_diff(root, folder)
                log(f"[prep] symmetric labels differ from JAX's: {differ} "
                    f"of {fg} foreground pixels against renders from the "
                    f"JAX package's canonical poses (which hash to JAX's "
                    f"labels: {ref_ok})")
                check(ref_ok and differ <= 1e-4 * fg,
                      "symmetric labels differ beyond 1e-4 of the "
                      "foreground")
            else:
                check(ok, f"generate-labels ({key}): label ids differ from "
                      "the JAX package's")
            log(f"[prep] generate-labels --data_folder test ({key}): {n} "
                f"label images in {secs:.2f} s (partition, then renders and "
                f"PNG writes on the host); label ids "
                + ("equal to the JAX package's" if ok else
                   f"{differ} foreground pixels apart") + f" ({sha[:16]})")
            rec["labels"][key] = {"images": n, "s": secs, "equal": ok,
                                  "pixels_apart": differ}
    finally:
        with open(info_path, "w") as f:
            f.write(info)

    # 4. a train_pbr split of .jpg frames, labelled by generate-labels,
    # and `train` on it
    cfg_pbr = write_pbr_split(root)
    rc = cli.main(["generate-labels", "--cfg", cfg_pbr, "--obj_name", "ape",
                   "--data_folder", "train_pbr"])
    check(rc == 0, f"generate-labels (train_pbr) returned {rc}")
    out = os.path.join(tmp, "runs_prep")
    run = os.path.join(out, "lmo_ape")
    reads = {"jpg": 0, "labels": 0}
    imread = png.imread

    def counted(path, flags=png.IMREAD_COLOR):
        if "/train_pbr/" in path and path.endswith(".jpg"):
            reads["jpg"] += 1
        if "/train_pbr_GT_v2/" in path:
            reads["labels"] += 1
        return imread(path, flags)

    png.imread = counted
    minimal_epnp_hypotheses.launches = 0          # the prep path's run
    t0 = time.perf_counter()
    try:
        rc = cli.main(["train", "--cfg", cfg_pbr, "--obj_name", "ape",
                       "--from_scratch", "--bf16", "--cache_images",
                       "--log_freq", str(PREP_STEPS), "--max_steps",
                       str(PREP_STEPS), "--output_dir", out, "--device",
                       str(dev)])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        png.imread = imread
    wall = time.perf_counter() - t0
    launches = minimal_epnp_hypotheses.launches
    check(rc == 0, f"train on train_pbr returned {rc}")
    rows = _metrics_rows(run)
    losses = [r["value"] for r in rows if r["tag"] == "train/step_loss_total"]
    timing = {r["tag"][len("timing/"):]: r["value"] for r in rows
              if r["tag"].startswith("timing/")}
    n_val = sum(r["tag"] == "val/ADD_recall_0.1d" for r in rows)
    val_batches = -(-TREE_FRAMES // 16)
    train_s = timing["fit_s"] - timing["val_s"] - timing["log_s"]
    step_ms = 1e3 * train_s / timing["steps"]
    wait = timing["wait_s"] / train_s
    log(f"[prep] `train --from_scratch --bf16 --cache_images` on "
        f"train_pbr ({PREP_FRAMES} .jpg frames, labels by generate-labels), "
        f"b{PREP_BATCH}, {len(losses)} steps in {wall:.1f} s: {reads['jpg']} "
        f".jpg reads, {reads['labels']} label reads; loss_total first "
        f"{losses[0]:.4f}, last {losses[-1]:.4f}; {step_ms:.1f} ms a step "
        f"over the steps' share, waiting for a batch {100 * wait:.1f}% of "
        f"it; {n_val} pose validation(s) over {TREE_FRAMES} frames at b16 "
        f"in {timing['val_s']:.2f} s, {launches} kernel launches; on {card}")
    check(reads["jpg"] >= PREP_FRAMES and reads["labels"] >= PREP_FRAMES,
          "train did not read the .jpg frames and the generated labels")
    check(len(losses) == PREP_STEPS and all(np.isfinite(losses)),
          "a training loss is missing or not finite")
    check(n_val >= 1 and launches >= n_val * val_batches,
          "validation did not launch the EPnP kernel on every batch")
    rec.update(reads=reads, losses=[losses[0], losses[-1]], step_ms=step_ms,
               wait_share=wait, train_wall_s=wall, timing=timing,
               launches=launches, validations=n_val)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[prep] phase 10 took {rec['phase_s']:.1f} s")
    return rec


def _symmetric_label_diff(root, folder):
    """The symmetric labels in `folder` against renders of the same mesh
    from the JAX package's canonical poses (committed): (foreground
    pixels apart, foreground pixels, whether those renders hash to the
    JAX package's labels)."""
    from zebrapose_tpu_torch import native
    from zebrapose_tpu_torch.data import bop_io, png

    mesh = bop_io.load_ply(os.path.join(root, "lmo", "models",
                                        "obj_000001.ply"))
    pts = mesh["pts"].astype(np.float32)
    faces = mesh["faces"].astype(np.int32)
    face_class = native.face_classes(native.partition_mesh(pts, 2, 16), faces)
    ref = np.load(os.path.join(FIXTURES, "sphere_sym_poses.npz"))
    h = hashlib.sha256()
    apart = fg = 0
    for im, name in enumerate(sorted(os.listdir(folder))):
        ids, _ = native.render_label(pts, faces, face_class.astype(np.int32),
                                     K_LMO, ref["R"][im], ref["t"][im], 640,
                                     480)
        h.update(name.encode())
        h.update(ids.astype(np.uint32).tobytes())
        bgr = png.imread(os.path.join(folder, name)).astype(np.int64)
        got = (bgr[..., 0] << 16) | (bgr[..., 1] << 8) | bgr[..., 2]
        fg += int(((got > 0) | (ids > 0)).sum())
        apart += int((got != ids).sum())
    return apart, fg, h.hexdigest() == JAX_CPU_LABELS["continuous_z"]


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
                    help="write the runner and training phases' BOP tree "
                    "(and the configs DIR/lmo_ape.txt, "
                    "DIR/lmo_ape_train.txt) on the CPU, and stop")
    opts = ap.parse_args(argv)
    if opts.write_tree:
        sys.path.insert(0, HERE)
        root = os.path.abspath(opts.write_tree)
        cfg_path, _, _ = write_tree(root)
        log(f"[tree] {cfg_path}")
        log(f"[tree] {write_train_split(root)}")
        log(f"[tree] {os.path.join(root, 'lmo_ape_vivo.txt')}")
        return 0
    import torch

    t_start = time.perf_counter()
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
    # every N the driven paths launch: the training path's validation at
    # b16 (2048), b32 (4096), the runner's escalated stage 2 at b32
    # (8192), b256 (32768), [main]'s escalated b256 (65536)
    for n, noise in ((2048, 0.5), (4096, 0.0), (4096, 0.5), (8192, 0.5),
                     (32768, 0.5), (65536, 0.5)):
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

    # ---- 7. the test runner, 8. the training path, 9. BOP, 10. prep ---
    with tempfile.TemporaryDirectory() as tmp:
        runner = runner_phase(dev, card, tmp)
        train = train_phase(dev, card, tmp)
        bop = bop_phase(dev, card, tmp)
        prep = prep_phase(dev, card, tmp, runner["png_decode_ms"])

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
                  for k, v in runner["runs"].items()},
               "train": train["launches"], "vivo": bop["launches"],
               "prep": prep["launches"]},
           "runner": runner, "train": train, "bop": bop, "prep": prep,
           "card": card}
    if ab:
        rec["ab"] = {str(n): v for n, v in ab.items()}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [rec]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
