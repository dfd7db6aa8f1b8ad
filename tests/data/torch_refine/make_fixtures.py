"""Write the contour-refinement fixtures and their manifest.

    python tests/data/torch_refine/make_fixtures.py [--skip-jax-test]

Needs cv2 and the JAX package (run it where both are installed, with
JAX_PLATFORMS=cpu). Writes, next to this script:

  * contours.npz: 48 seeded masks (noise, XORed rectangles with holes
    and islands, thin strokes, XORed rings; up to 96x96) as packed bits,
    and `cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE)` of
    each: its contours' lengths and points in cv2's order;
  * refine.npz: for 4 frames of the rehearsal sphere (`chip_smoke.
    sphere_frame(default_rng([REFINE_SEED, i]))`, 480x640, LM-O K), the
    outer contour of the analytic silhouette (cv2), a start pose = the
    frame's pose turned by ~2 degrees and moved by a few mm (seeded), and
    the pose the JAX package's `native.edge_refine` refines it to on
    `chip_smoke.uv_sphere()` (10 iterations, damping 5e3 / 5e5);
  * manifest.json: the SHA-256 of the text surface code that the JAX
    package's `generate_mesh_surface_code` writes for the sphere with
    d = 4, n = 8 (seed 0), and the metrics of the JAX package's `test`
    with `refine = True` over `chip_smoke.write_tree` (120 frames, the
    committed rehearsal checkpoint, b32; `JAX_CPU_REFINE` of
    chip_smoke.py's phase 11), with the compiler and versions used.

`tests/test_torch_refine.py` re-derives the contours with cv2 and holds
the port to every record; `chip_smoke.py` holds the port to them on the
card's machine, which has no cv2 and no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
N_MASKS, MASK_SEED = 48, 80
N_REFINE, REFINE_SEED = 4, 81


def random_mask(rng, i, max_side=96):
    """A seeded mask of one of four kinds (by i % 4)."""
    h, w = (int(v) for v in rng.integers(1, max_side, 2))
    kind = i % 4
    if kind == 0:
        m = rng.random((h, w)) < rng.uniform(0.05, 0.95)
    elif kind == 1:
        m = np.zeros((h, w), bool)
        for _ in range(rng.integers(1, 8)):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            y1, x1 = y0 + rng.integers(1, 30), x0 + rng.integers(1, 30)
            m[y0:y1, x0:x1] = ~m[y0:y1, x0:x1]
    elif kind == 2:
        m = rng.random((h, w)) < 0.5
        m |= np.roll(m, 1, 0)
    else:
        m = np.zeros((h, w), bool)
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(rng.integers(1, 6)):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            r = int(rng.integers(1, 25))
            d = (yy - y0) ** 2 + (xx - x0) ** 2
            m ^= (d <= r * r) & (d >= (r - int(rng.integers(1, 3))) ** 2)
    return m


def cv2_contours(mask):
    import cv2

    found, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                                cv2.CHAIN_APPROX_NONE)
    return [c[:, 0, :].astype(np.int32) for c in found]


def write_contours():
    rng = np.random.default_rng(MASK_SEED)
    shapes, bits, n_contours, lens, pts = [], [], [], [], []
    for i in range(N_MASKS):
        m = random_mask(rng, i)
        shapes.append(m.shape)
        bits.append(np.packbits(m.reshape(-1)))
        cs = cv2_contours(m)
        n_contours.append(len(cs))
        lens += [len(c) for c in cs]
        pts += cs
    np.savez_compressed(
        os.path.join(HERE, "contours.npz"),
        shapes=np.array(shapes, np.int32),
        bit_lens=np.array([len(b) for b in bits], np.int32),
        bits=np.concatenate(bits),
        n_contours=np.array(n_contours, np.int32),
        lens=np.array(lens, np.int32),
        points=np.concatenate(pts).astype(np.int32))
    return sum(n_contours)


def rotation(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    th = np.radians(deg)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def write_refine():
    import chip_smoke
    from zebrapose_tpu import native

    pts, faces = chip_smoke.uv_sphere()
    rays = chip_smoke.pixel_rays()
    K = chip_smoke.K_LMO.astype(np.float64)
    out = {k: [] for k in ("lens", "points", "R0", "t0", "R", "t", "R_gt",
                           "t_gt")}
    secs = 0.0
    for i in range(N_REFINE):
        rng = np.random.default_rng([REFINE_SEED, i])
        _, hit, _, _, R, t = chip_smoke.sphere_frame(rng, rays)
        (contour,) = cv2_contours(hit)
        R0 = rotation(rng, rng.uniform(1.5, 2.5)) @ R
        t0 = t + np.array([rng.uniform(-3, 3), rng.uniform(-3, 3),
                           rng.uniform(-6, 6)])
        t_start = time.perf_counter()
        R1, t1 = native.edge_refine(pts, faces.astype(np.int32), K, 640,
                                    480, contour, R0, t0)
        secs += time.perf_counter() - t_start
        for k, v in (("lens", len(contour)), ("points", contour),
                     ("R0", R0), ("t0", t0), ("R", R1), ("t", t1),
                     ("R_gt", R), ("t_gt", t)):
            out[k].append(v)
    np.savez_compressed(
        os.path.join(HERE, "refine.npz"),
        lens=np.array(out["lens"], np.int32),
        points=np.concatenate(out["points"]).astype(np.int32),
        **{k: np.array(out[k], np.float64) for k in
           ("R0", "t0", "R", "t", "R_gt", "t_gt")})
    return secs / N_REFINE


def base4_lut_sha():
    import chip_smoke
    from zebrapose_tpu.data.bop_io import save_ply
    from zebrapose_tpu.tools.generate_gt import generate_mesh_surface_code

    pts, faces = chip_smoke.uv_sphere()
    with tempfile.TemporaryDirectory() as tmp:
        ply = os.path.join(tmp, "sphere.ply")
        save_ply(ply, pts, faces=faces)
        txt = os.path.join(tmp, "lut.txt")
        generate_mesh_surface_code(ply, 4, 8, txt)
        with open(txt, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()


def jax_refine_test():
    """The JAX package's `test` with refine = True over the chip tree."""
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "bop")
        cfg, _, _ = chip_smoke.write_tree(root)
        with open(cfg) as f, open(cfg[:-4] + "_refine.txt", "w") as g:
            g.write(f.read() + "refine = True\n")
        out = os.path.join(tmp, "out")
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "zebrapose_tpu", "test", "--cfg",
             cfg[:-4] + "_refine.txt", "--obj_name", "ape", "--ckpt_file",
             chip_smoke.CKPT, "--batch_size", "32", "--output_dir", out],
            cwd=REPO, env=env, check=True, capture_output=True)
        wall = time.perf_counter() - t0
        (run,) = os.listdir(out)
        with open(os.path.join(out, run, "log.txt")) as f:
            metrics = {k: float(v) for k, v in (
                ln.split() for ln in f.read().splitlines()
                if ln.startswith("ADD"))}
        return metrics, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-jax-test", action="store_true",
                    help="keep the manifest's recorded JAX test metrics")
    opts = ap.parse_args()
    sys.path.insert(0, REPO)
    import cv2
    import jax

    path = os.path.join(HERE, "manifest.json")
    manifest = {}
    if os.path.exists(path):
        with open(path) as f:
            manifest = json.load(f)
    cxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    manifest["contours"] = write_contours()
    manifest["jax_refine_s_a_frame"] = write_refine()
    manifest["base4_lut_sha256"] = base4_lut_sha()
    if not opts.skip_jax_test:
        metrics, wall = jax_refine_test()
        manifest["jax_cpu_refine"] = metrics
        manifest["jax_cpu_refine_wall_s"] = wall
    manifest["made_with"] = (f"cv2 {cv2.__version__}, JAX {jax.__version__}"
                             f" on the CPU, native library by {cxx}")
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(json.dumps(manifest, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
