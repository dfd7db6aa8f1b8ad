"""BOP19 submission scoring: CSV -> AR_{VSD,MSSD,MSPD} without bop_toolkit.

Port of `zebrapose_tpu/eval/bop_score.py`. Walks the BOP tree with the
port's IO layer, computes all (estimate, GT) error pairs of an object as
batched programs on the device (`ops/bop_errors.py`; CUDA unless "cpu"
is asked for), applies the BOP19 greedy score-ordered matching on the
host, and reports pooled + per-object average recalls. VSD is included
automatically when the split ships depth images; its depth renders run
on the host (the port's rasterizer, `zebrapose_tpu_torch/native`), its
visibility and cost math on the device.
"""

from __future__ import annotations

import os
import time
import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from zebrapose_tpu_torch.data import bop_io, png
from zebrapose_tpu_torch.ops.bop_errors import (
    _vsd_errors,
    _vsd_parts,
    get_symmetry_transformations,
    mspd_batch,
    mssd_batch,
)
from zebrapose_tpu_torch.utils.device import resolve_device

VISIB_GT_MIN = 0.1  # bop19: GT instances visible from >10% count
THETAS = np.arange(0.05, 0.51, 0.05)  # VSD/MSSD correctness thresholds
MSPD_THETAS = np.arange(5, 51, 5)  # px at 640-width
TAUS = np.arange(0.05, 0.51, 0.05)  # VSD misalignment tolerances


def read_csv(path: str) -> List[dict]:
    """Parse a BOP submission CSV (bop_writer.write_csv row contract)."""
    out = []
    with open(path) as f:
        header = f.readline()
        if not header.strip().startswith("scene_id"):
            raise ValueError(f"{path}: missing CSV header")
        for line in f:
            if not line.strip():
                continue
            scene, im, obj, score, r, t, tm = line.strip().split(",")
            out.append({
                "scene_id": int(scene), "im_id": int(im),
                "obj_id": int(obj), "score": float(score),
                "R": np.array(r.split(), float).reshape(3, 3),
                "t": np.array(t.split(), float),
                "time": float(tm)})
    return out


def match_poses(errs: np.ndarray, scores: Sequence[float],
                theta: float) -> int:
    """BOP19 greedy matching for one image/object/threshold.

    errs: [n_est, n_gt] error matrix; estimates processed in descending
    detection score, each taking the lowest-error still-unmatched GT if
    that error is below theta (bop_toolkit pose_matching semantics).
    Returns the number of matched GT instances."""
    n_est, n_gt = errs.shape
    taken = np.zeros(n_gt, bool)
    matched = 0
    for i in np.argsort(-np.asarray(scores), kind="stable"):
        free = ~taken
        if not free.any():
            break
        j = int(np.flatnonzero(free)[np.argmin(errs[i][free])])
        if errs[i, j] < theta:
            taken[j] = True
            matched += 1
    return matched


def _load_depth(scene_dir: str, im_id: int, depth_scale: float
                ) -> Optional[np.ndarray]:
    fn = os.path.join(scene_dir, "depth", f"{im_id:06d}.png")
    if not os.path.exists(fn):
        return None
    d = png.imread(fn, png.IMREAD_UNCHANGED)
    if d is None:
        return None
    return d.astype(np.float32) * float(depth_scale)


def score_csv(csv_path: str, bop_path: str, dataset: str,
              split: str = "test",
              max_sym_disc_step: float = 0.01,
              with_vsd: Optional[bool] = None,
              vsd_delta: float = 15.0, device=None,
              timing: Optional[Dict[str, float]] = None,
              pair_errors: Optional[Dict[int, Dict[str, np.ndarray]]] = None
              ) -> Dict:
    """Score a submission CSV against a BOP dataset split.

    Returns {"AR", "AR_mssd", "AR_mspd"[, "AR_vsd"], "per_object": {...},
    "n_targets": N}. Target set: test_targets_bop19.json when present
    (inst_count denominators), else every GT instance with
    visib_fract > 0.1 in the split. with_vsd=None auto-enables VSD when
    the split ships depth images. The errors run on `device` (CUDA
    unless "cpu" is asked for); the walk, the renders and the matching
    on the host.

    `timing`, when given, is filled with seconds of this run: score_s
    (the whole call), errors_s (MSSD and MSPD on the device, copies
    back included), render_s (VSD's depth renders, host), vsd_s (VSD's
    pixel math on the device) and match_s (the matching, host).
    `pair_errors`, when given, is filled per object id with the errors
    of every (estimate, GT) pair in scoring order: "mssd", "mspd" [n],
    and with VSD "vsd" [n, len(TAUS)] and "vsd_union" [n] (pixels in
    each pair's union)."""
    dev = resolve_device(device)
    t_run = time.perf_counter()
    clock = dict.fromkeys(("errors_s", "render_s", "vsd_s", "match_s"), 0.0)
    ds_dir = os.path.join(bop_path, dataset)
    model_dir = os.path.join(ds_dir, "models_eval")
    if not os.path.isdir(model_dir):
        model_dir = os.path.join(ds_dir, "models")
    plys, model_info, _ = bop_io._list_models(model_dir)
    try:
        cam_global = bop_io.load_cam_params(
            os.path.join(ds_dir, bop_io._camera_file(dataset)))
        im_width = float(cam_global.get("width", 640))
    except FileNotFoundError:
        im_width = 640.0

    ests = defaultdict(list)
    for row in read_csv(csv_path):
        ests[(row["scene_id"], row["im_id"], row["obj_id"])].append(row)

    # ---- enumerate targets ---------------------------------------------
    targets_fn = os.path.join(ds_dir, "test_targets_bop19.json")
    targets: Dict[Tuple[int, int, int], int] = {}
    if os.path.exists(targets_fn):
        for tgt in bop_io.load_json(targets_fn):
            key = (int(tgt["scene_id"]), int(tgt["im_id"]),
                   int(tgt["obj_id"]))
            targets[key] = int(tgt.get("inst_count", 1))
        scene_ids = sorted({k[0] for k in targets})
    else:
        split_dir = os.path.join(ds_dir, split)
        scene_ids = sorted(int(d) for d in os.listdir(split_dir)
                           if d.isdigit())

    # ---- walk scenes, collect (est, gt) pairs per object ---------------
    # pairs[obj] = per-image records for batched error evaluation
    pairs: Dict[int, List[dict]] = defaultdict(list)
    n_gt_total: Dict[int, int] = defaultdict(int)
    for sid in scene_ids:
        sdir = os.path.join(ds_dir, split, f"{sid:06d}")
        sgt = bop_io.load_scene_gt(os.path.join(sdir, "scene_gt.json"))
        sgti = bop_io.load_scene_gt(os.path.join(sdir, "scene_gt_info.json"))
        scam = bop_io.load_scene_camera(
            os.path.join(sdir, "scene_camera.json"))
        for im_id, gt_list in sgt.items():
            by_obj: Dict[int, List[dict]] = defaultdict(list)
            for gi, gt in enumerate(gt_list):
                oid = int(gt["obj_id"])
                if targets and (sid, im_id, oid) not in targets:
                    continue
                # bop19 validity: visib_fract >= visib_gt_min (the
                # boundary value 0.1 COUNTS)
                if sgti[im_id][gi].get("visib_fract", 1.0) < VISIB_GT_MIN:
                    continue
                by_obj[oid].append(gt)
            for oid, gts in by_obj.items():
                n_gt_total[oid] += len(gts)
                cam = scam[im_id]
                cand = ests.get((sid, im_id, oid), [])
                if targets:
                    # official BOP19: only the top-inst_count estimates
                    # by score are evaluated per target
                    n_keep = targets[(sid, im_id, oid)]
                    cand = sorted(cand, key=lambda e: -e["score"])[:n_keep]
                pairs[oid].append({
                    "scene_id": sid, "im_id": im_id, "scene_dir": sdir,
                    "K": np.asarray(cam["cam_K"],
                                    np.float64).reshape(3, 3),
                    "depth_scale": cam.get("depth_scale", 1.0),
                    "gt_R": [np.asarray(g["cam_R_m2c"],
                                        np.float64).reshape(3, 3)
                             for g in gts],
                    "gt_t": [np.asarray(g["cam_t_m2c"], np.float64)
                             for g in gts],
                    "ests": cand})

    if not any(n_gt_total.values()):
        raise ValueError(
            "no GT targets: the target list / visibility filter left "
            "nothing to score (check test_targets_bop19.json and the "
            f"'{split}' split under {ds_dir})")

    # Decide VSD availability ONCE, up front: partial depth coverage
    # must not make per-object ARs incomparable (3-component for early
    # objects, 2-component later).
    vsd_enabled = with_vsd
    if vsd_enabled is None:
        have_depth = [
            os.path.exists(os.path.join(
                rec["scene_dir"], "depth", f"{rec['im_id']:06d}.png"))
            for recs in pairs.values() for rec in recs]
        vsd_enabled = all(have_depth)
        if any(have_depth) and not vsd_enabled:
            warnings.warn(
                f"VSD disabled: only {sum(have_depth)}/{len(have_depth)} "
                "scored images have depth (mixed coverage would make "
                "per-object ARs incomparable). AR pools MSSD+MSPD only; "
                "pass with_vsd=True to fail loudly on the missing files "
                "instead.", stacklevel=2)

    # ---- per-object batched errors + matching --------------------------
    per_object: Dict[int, Dict] = {}
    pooled = {"mssd": [0] * len(THETAS), "mspd": [0] * len(MSPD_THETAS),
              "vsd": [0] * (len(TAUS) * len(THETAS))}
    pooled_gt = 0

    def on(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for oid, recs in sorted(pairs.items()):
        mesh = bop_io.load_ply(plys[oid])
        pts = mesh["pts"].astype(np.float32)
        faces = mesh.get("faces")
        info = model_info[str(oid)]
        diameter = float(info["diameter"])
        sym_R, sym_t = get_symmetry_transformations(info,
                                                    max_sym_disc_step)

        # flatten every (est, gt) pair of every image into one batch
        flat = {"Re": [], "te": [], "Rg": [], "tg": [], "K": []}
        index: List[Tuple[int, int, int]] = []  # (rec_i, n_est, n_gt)
        for ri, rec in enumerate(recs):
            n_e, n_g = len(rec["ests"]), len(rec["gt_R"])
            index.append((ri, n_e, n_g))
            for e in rec["ests"]:
                for Rg, tg in zip(rec["gt_R"], rec["gt_t"]):
                    flat["Re"].append(e["R"])
                    flat["te"].append(e["t"])
                    flat["Rg"].append(Rg)
                    flat["tg"].append(tg)
                    flat["K"].append(rec["K"])

        vsd_union = None
        if flat["Re"]:
            t0 = time.perf_counter()
            with torch.no_grad():
                Re, te, Rg, tg, Kf = (on(np.stack(flat[k])) for k in
                                      ("Re", "te", "Rg", "tg", "K"))
                pts_d, sR, st = on(pts), on(sym_R), on(sym_t)
                e_mssd = mssd_batch(Re, te, Rg, tg, pts_d, sR, st) \
                    .cpu().numpy()
                e_mspd = mspd_batch(Re, te, Rg, tg, Kf, pts_d, sR, st) \
                    .cpu().numpy()
            clock["errors_s"] += time.perf_counter() - t0
            if vsd_enabled:
                e_vsd, vsd_union = _pair_vsd(recs, index, pts, faces,
                                             diameter, vsd_delta, dev,
                                             clock)
            else:
                e_vsd = None
        else:
            e_mssd = e_mspd = np.zeros((0,))
            e_vsd = np.zeros((0, len(TAUS))) if vsd_enabled else None
        if pair_errors is not None:
            pair_errors[oid] = {"mssd": e_mssd, "mspd": e_mspd}
            if e_vsd is not None:
                pair_errors[oid].update(
                    vsd=e_vsd, vsd_union=(np.zeros((0,), np.int64)
                                          if vsd_union is None
                                          else vsd_union))

        t0 = time.perf_counter()
        obj = {"mssd": [0] * len(THETAS), "mspd": [0] * len(MSPD_THETAS),
               "vsd": [0] * (len(TAUS) * len(THETAS))}
        off = 0
        for ri, n_e, n_g in index:
            rec = recs[ri]
            n_pairs = n_e * n_g
            scores = [e["score"] for e in rec["ests"]]
            r = im_width / 640.0  # bop19 MSPD pixel-threshold scaling
            em = e_mssd[off:off + n_pairs].reshape(n_e, n_g)
            ep = e_mspd[off:off + n_pairs].reshape(n_e, n_g)
            for k, th in enumerate(THETAS):
                obj["mssd"][k] += match_poses(em, scores, th * diameter)
            for k, th in enumerate(MSPD_THETAS):
                obj["mspd"][k] += match_poses(ep, scores, th * r)
            if e_vsd is not None:
                ev = e_vsd[off:off + n_pairs].reshape(n_e, n_g, len(TAUS))
                k = 0
                for ti in range(len(TAUS)):
                    for th in THETAS:
                        obj["vsd"][k] += match_poses(ev[..., ti], scores,
                                                     th)
                        k += 1
            off += n_pairs
        clock["match_s"] += time.perf_counter() - t0

        n_gt = n_gt_total[oid]
        pooled_gt += n_gt
        entry = {
            "AR_mssd": float(np.mean([m / n_gt for m in obj["mssd"]])),
            "AR_mspd": float(np.mean([m / n_gt for m in obj["mspd"]])),
            "n_targets": n_gt}
        comps = [entry["AR_mssd"], entry["AR_mspd"]]
        if vsd_enabled:
            entry["AR_vsd"] = float(np.mean(
                [m / n_gt for m in obj["vsd"]]))
            comps.append(entry["AR_vsd"])
        entry["AR"] = float(np.mean(comps))
        per_object[oid] = entry
        for key in ("mssd", "mspd", "vsd"):
            pooled[key] = [a + b for a, b in zip(pooled[key], obj[key])]

    out = {
        "AR_mssd": float(np.mean([m / pooled_gt
                                  for m in pooled["mssd"]])),
        "AR_mspd": float(np.mean([m / pooled_gt
                                  for m in pooled["mspd"]])),
        "per_object": per_object, "n_targets": pooled_gt}
    comps = [out["AR_mssd"], out["AR_mspd"]]
    if vsd_enabled:
        out["AR_vsd"] = float(np.mean([m / pooled_gt
                                       for m in pooled["vsd"]]))
        comps.append(out["AR_vsd"])
    out["AR"] = float(np.mean(comps))
    if timing is not None:
        timing.update(clock, score_s=time.perf_counter() - t_run)
    return out


def _pair_vsd(recs: List[dict], index, pts, faces, diameter: float,
              delta: float, dev: torch.device, clock: Dict[str, float]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pair VSD errors [n_pairs, len(TAUS)] and union pixel counts
    [n_pairs], with one render per distinct pose (not per pair) and one
    device program per image. Depth availability is prechecked by
    score_csv; a file vanishing between the check and the read raises.
    Adds render and device seconds to `clock`."""
    from zebrapose_tpu_torch.native import render_label

    labels = np.ones(len(faces), np.int32)
    taus = torch.as_tensor(TAUS.astype(np.float32), device=dev)
    errs, unions = [], []
    for ri, n_e, n_g in index:
        rec = recs[ri]
        if n_e * n_g == 0:
            continue
        t0 = time.perf_counter()
        depth_test = _load_depth(rec["scene_dir"], rec["im_id"],
                                 rec["depth_scale"])
        if depth_test is None:
            raise FileNotFoundError(
                f"depth image for scene {rec['scene_id']} im "
                f"{rec['im_id']} disappeared after the availability "
                "pre-check")
        h, w = depth_test.shape
        K = rec["K"]

        def render(R, t):
            _, d = render_label(pts, faces, labels, K,
                                np.asarray(R, np.float64),
                                np.asarray(t, np.float64).reshape(3),
                                w, h, with_depth=True)
            return d

        d_est = [render(e["R"], e["t"]) for e in rec["ests"]]
        d_gt = [render(R, t) for R, t in zip(rec["gt_R"], rec["gt_t"])]
        gt_s = np.stack([d_gt[j] for _ in range(n_e) for j in range(n_g)])
        est_s = np.stack([d_est[i] for i in range(n_e) for _ in range(n_g)])
        t1 = time.perf_counter()
        clock["render_s"] += t1 - t0
        n = n_e * n_g
        with torch.no_grad():
            test_s = torch.as_tensor(depth_test, device=dev).expand(n, h, w)
            Ks = torch.as_tensor(K.astype(np.float32),
                                 device=dev).expand(n, 3, 3)
            costs, comp, union = _vsd_parts(
                test_s, torch.as_tensor(gt_s, device=dev),
                torch.as_tensor(est_s, device=dev), Ks, taus,
                float(delta), torch.full((n,), diameter, device=dev))
            errs.append(_vsd_errors(costs, comp, union).cpu().numpy())
            unions.append(union.cpu().numpy())
        clock["vsd_s"] += time.perf_counter() - t1
    if not errs:
        return np.zeros((0, len(TAUS))), np.zeros((0,), np.int64)
    return np.concatenate(errs), np.concatenate(unions)
