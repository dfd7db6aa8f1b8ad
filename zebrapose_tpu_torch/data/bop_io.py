"""Self-contained BOP-layout dataset walker (no bop_toolkit dependency).

Re-creates the behavior of the reference's `tools_for_BOP/bop_io.py`
(itself leaning on the external bop_toolkit `inout`): scan
`<bop>/<dataset>/<split>/<scene>/` for scene_camera / scene_gt /
scene_gt_info JSONs, fan samples out per object id filtered by
`visib_fract`, resolve rgb/gray/mask/mask_visib paths (itodd gray .tif and
.jpg fallbacks included), plus the BOP-challenge `test_targets_bop19.json`
variant and per-dataset camera file quirks (ycbv camera_uw, tless
camera_primesense).

Also includes a compact PLY reader (ascii + binary_little_endian) for the
model meshes — enough for ADD/ADI vertices and mesh partitioning.

The port's copy of `zebrapose_tpu/data/bop_io.py`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Low-level IO
# ---------------------------------------------------------------------------

def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def load_cam_params(path: str) -> Dict[str, Any]:
    """camera.json -> dict with K [3,3], im_size (w, h), depth_scale."""
    c = load_json(path)
    out = dict(c)
    out["K"] = np.array([[c["fx"], 0, c["cx"]],
                         [0, c["fy"], c["cy"]],
                         [0, 0, 1]], dtype=np.float64)
    out["im_size"] = (int(c["width"]), int(c["height"]))
    return out


def load_scene_camera(path: str) -> Dict[int, Dict[str, Any]]:
    """scene_camera.json -> {im_id: {cam_K [3,3], depth_scale, ...}}."""
    raw = load_json(path)
    out = {}
    for im_id, v in raw.items():
        d = dict(v)
        if "cam_K" in d:
            d["cam_K"] = np.array(d["cam_K"], np.float64).reshape(3, 3)
        if "cam_R_w2c" in d:
            d["cam_R_w2c"] = np.array(d["cam_R_w2c"],
                                      np.float64).reshape(3, 3)
        if "cam_t_w2c" in d:
            d["cam_t_w2c"] = np.array(d["cam_t_w2c"],
                                      np.float64).reshape(3, 1)
        out[int(im_id)] = d
    return out


def load_scene_gt(path: str) -> Dict[int, List[Dict[str, Any]]]:
    """scene_gt.json / scene_gt_info.json -> {im_id: [per-instance dict]}."""
    raw = load_json(path)
    out = {}
    for im_id, insts in raw.items():
        lst = []
        for inst in insts:
            d = dict(inst)
            if "cam_R_m2c" in d:
                d["cam_R_m2c"] = np.array(d["cam_R_m2c"],
                                          np.float64).reshape(3, 3)
            if "cam_t_m2c" in d:
                d["cam_t_m2c"] = np.array(d["cam_t_m2c"],
                                          np.float64).reshape(3)
            lst.append(d)
        out[int(im_id)] = lst
    return out


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Minimal PLY reader: returns {"pts" [N,3] float64, "faces" [M,3] int,
    "colors" [N,3] uint8 (if present), "normals" (if present)}."""
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_name, type) or ("list",...)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if tok[1] == "list":
                    cur[2].append(("list", tok[2], tok[3], tok[4]))
                else:
                    cur[2].append(("scalar", tok[1], tok[2]))
            elif tok[0] == "end_header":
                break

        out: Dict[str, np.ndarray] = {}
        if fmt == "ascii":
            rows_by_elem = {}
            for name, count, props in elements:
                rows = []
                for _ in range(count):
                    rows.append(f.readline().split())
                rows_by_elem[name] = rows
            for name, count, props in elements:
                rows = rows_by_elem[name]
                if name == "vertex":
                    _parse_vertex_rows(rows, props, out)
                elif name == "face":
                    out["faces"] = np.array(
                        [[int(v) for v in r[1:1 + int(r[0])]][:3]
                         for r in rows], np.int64)
        elif fmt == "binary_little_endian":
            for name, count, props in elements:
                if name == "vertex" and all(p[0] == "scalar"
                                            for p in props):
                    fmt_str = "<" + "".join(
                        _PLY_TYPES[p[1]][0] for p in props)
                    sz = struct.calcsize(fmt_str)
                    buf = f.read(sz * count)
                    arr = np.frombuffer(
                        buf, dtype=np.dtype(
                            [(p[2], "<" + _PLY_TYPES[p[1]][0])
                             for p in props]))
                    _vertex_from_struct(arr, props, out)
                elif name == "face":
                    faces = []
                    for _ in range(count):
                        p = props[0]
                        cnt_t, idx_t = _PLY_TYPES[p[2]], _PLY_TYPES[p[3]]
                        n = struct.unpack(
                            "<" + cnt_t[0], f.read(cnt_t[1]))[0]
                        idx = struct.unpack(
                            "<" + idx_t[0] * n, f.read(idx_t[1] * n))
                        faces.append(idx[:3])
                    out["faces"] = np.array(faces, np.int64)
                else:
                    # skip unknown fixed-size element
                    row = sum(_PLY_TYPES[p[1]][1] for p in props
                              if p[0] == "scalar")
                    f.read(row * count)
        else:
            raise ValueError(f"unsupported PLY format: {fmt}")
    return out


def _parse_vertex_rows(rows, props, out):
    names = [p[2] for p in props]
    arr = np.array([[float(v) for v in r] for r in rows], np.float64)
    cols = {n: arr[:, i] for i, n in enumerate(names)}
    _vertex_cols_to_out(cols, out)


def _vertex_from_struct(arr, props, out):
    cols = {p[2]: np.asarray(arr[p[2]], np.float64) for p in props}
    _vertex_cols_to_out(cols, out)


def _vertex_cols_to_out(cols, out):
    out["pts"] = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    if all(k in cols for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack(
            [cols["nx"], cols["ny"], cols["nz"]], axis=1)
    if all(k in cols for k in ("red", "green", "blue")):
        out["colors"] = np.stack(
            [cols["red"], cols["green"], cols["blue"]],
            axis=1).astype(np.uint8)


def save_ply(path: str, pts: np.ndarray,
             colors: Optional[np.ndarray] = None,
             faces: Optional[np.ndarray] = None) -> None:
    """ASCII PLY writer (colored-mesh output of the GT partitioner)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            row = f"{p[0]} {p[1]} {p[2]}"
            if colors is not None:
                c = colors[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(row + "\n")
        if faces is not None:
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


# ---------------------------------------------------------------------------
# Dataset walking
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BopSamples:
    """Per-object sample lists (index 0 = obj_id 1), mirroring the
    reference's data_per_obj=True outputs."""

    dataset_dir: str
    target_dir: str
    model_plys: Dict[int, str]
    model_info: Dict[str, Any]
    model_ids: np.ndarray
    rgb_files: List[List[str]]
    mask_files: List[List[List[str]]]
    mask_visib_files: List[List[List[str]]]
    gts: List[List[Optional[dict]]]
    gt_infos: List[List[Optional[dict]]]
    cam_params: List[List[dict]]
    cam_param_global: Dict[str, Any]

    def for_obj(self, obj_id: int):
        i = obj_id - 1
        return (self.rgb_files[i], self.mask_files[i],
                self.mask_visib_files[i], self.gts[i], self.gt_infos[i],
                self.cam_params[i])


def _camera_file(dataset: str) -> str:
    if dataset == "ycbv":
        return "camera_uw.json"
    if dataset in ("tless", "hb"):
        return "camera_primesense.json"
    return "camera.json"


def _rgb_path(scene_dir: str, dataset: str, im_id: int,
              train: bool) -> str:
    if dataset == "itodd" and not train:
        return os.path.join(scene_dir, "gray", f"{im_id:06d}.tif")
    p = os.path.join(scene_dir, "rgb", f"{im_id:06d}.png")
    if not os.path.exists(p):
        p = p[:-4] + ".jpg"
    return p


def _list_models(model_dir: str) -> Tuple[Dict[int, str], Dict, np.ndarray]:
    model_info = load_json(os.path.join(model_dir, "models_info.json"))
    plys, ids = {}, []
    for mid in model_info.keys():
        fn = os.path.join(model_dir, f"obj_{int(mid):06d}.ply")
        if os.path.exists(fn):
            ids.append(int(mid))
            plys[int(mid)] = fn
    return plys, model_info, np.sort(np.array(ids))


def get_dataset(bop_dir: str, dataset: str, train: bool = True,
                eval_model: bool = False, data_folder: str = "test",
                train_obj_visible_theshold: float = 0.1) -> BopSamples:
    """Walk a BOP split into per-object sample lists.

    Matches reference get_dataset(data_per_obj=True): instances filtered by
    visib_fract > threshold (0.1 at test, configurable at train); lmo's
    object-id space padded to 15 despite only 8 models.
    """
    dataset_dir = os.path.join(bop_dir, dataset)
    target_dir = os.path.join(dataset_dir, data_folder)
    model_dir = dataset_dir + "/models" + ("_eval" if eval_model else "")
    model_plys, model_info, model_ids = _list_models(model_dir)
    cam_global = load_cam_params(
        os.path.join(dataset_dir, _camera_file(dataset)))

    max_id = 15 if dataset == "lmo" else int(model_ids.max())
    n = max_id
    rgb: List[List[str]] = [[] for _ in range(n)]
    mask: List[List[List[str]]] = [[] for _ in range(n)]
    maskv: List[List[List[str]]] = [[] for _ in range(n)]
    gts: List[List[Optional[dict]]] = [[] for _ in range(n)]
    gtis: List[List[Optional[dict]]] = [[] for _ in range(n)]
    cams: List[List[dict]] = [[] for _ in range(n)]

    visib_threshold = train_obj_visible_theshold if train else 0.1

    if os.path.exists(target_dir):
        for scene in sorted(os.listdir(target_dir)):
            scene_dir = os.path.join(target_dir, scene)
            cam_fn = os.path.join(scene_dir, "scene_camera.json")
            if not os.path.exists(cam_fn):
                continue
            scene_cams = load_scene_camera(cam_fn)
            gt_fn = os.path.join(scene_dir, "scene_gt.json")
            gti_fn = os.path.join(scene_dir, "scene_gt_info.json")
            has_gt = os.path.exists(gt_fn) and os.path.exists(gti_fn)
            if not has_gt:
                continue
            scene_gts = load_scene_gt(gt_fn)
            scene_gtis = load_scene_gt(gti_fn)
            for im_id in sorted(scene_cams.keys()):
                rgb_fn = _rgb_path(scene_dir, dataset, im_id, train)
                for counter, gt in enumerate(scene_gts[im_id]):
                    info = scene_gtis[im_id][counter]
                    if info["visib_fract"] <= visib_threshold:
                        continue
                    oi = int(gt["obj_id"]) - 1
                    if oi >= n:
                        continue
                    rgb[oi].append(rgb_fn)
                    mask[oi].append([os.path.join(
                        scene_dir, "mask", f"{im_id:06d}_{counter:06d}.png")])
                    maskv[oi].append([os.path.join(
                        scene_dir, "mask_visib",
                        f"{im_id:06d}_{counter:06d}.png")])
                    gts[oi].append(gt)
                    gtis[oi].append(info)
                    cams[oi].append(scene_cams[im_id])

    return BopSamples(dataset_dir, target_dir, model_plys, model_info,
                      model_ids, rgb, mask, maskv, gts, gtis, cams,
                      cam_global)


def list_images_with_cameras(bop_dir: str, dataset: str,
                             data_folder: str = "test"
                             ) -> Tuple[List[str], Dict[str, dict]]:
    """Every image of a split from `scene_camera.json` alone — NO GT
    required (the BOP-challenge / vivo walk, reference
    test_vivo.py:127-131: camera params are read per scene directly, and
    the image loop is driven by the detection dict, not scene_gt).

    Returns (sorted rgb paths, {rgb path: scene_camera entry}).
    """
    target_dir = os.path.join(bop_dir, dataset, data_folder)
    rgb_files: List[str] = []
    cam_by_file: Dict[str, dict] = {}
    if os.path.exists(target_dir):
        for scene in sorted(os.listdir(target_dir)):
            scene_dir = os.path.join(target_dir, scene)
            cam_fn = os.path.join(scene_dir, "scene_camera.json")
            if not os.path.exists(cam_fn):
                continue
            scene_cams = load_scene_camera(cam_fn)
            for im_id in sorted(scene_cams.keys()):
                fn = _rgb_path(scene_dir, dataset, im_id, train=False)
                rgb_files.append(fn)
                cam_by_file[fn] = scene_cams[im_id]
    return rgb_files, cam_by_file


def get_bop_challenge_test_data(bop_dir: str, dataset: str,
                                target_obj_id: int,
                                data_folder: str = "test") -> BopSamples:
    """The BOP19 target-list variant (reference
    get_bop_challange_test_data): only images named in
    test_targets_bop19.json; visib filter 0.1 when GT available; dummy GT
    entries when the split ships without GT."""
    dataset_dir = os.path.join(bop_dir, dataset)
    model_dir = dataset_dir + "/models_eval"
    model_plys, model_info, model_ids = _list_models(model_dir)
    targets = load_json(
        os.path.join(dataset_dir, "test_targets_bop19.json"))

    n = int(model_ids.max())
    rgb: List[List[str]] = [[] for _ in range(n)]
    mask: List[List[List[str]]] = [[] for _ in range(n)]
    maskv: List[List[List[str]]] = [[] for _ in range(n)]
    gts: List[List[Optional[dict]]] = [[] for _ in range(n)]
    gtis: List[List[Optional[dict]]] = [[] for _ in range(n)]
    cams: List[List[dict]] = [[] for _ in range(n)]

    cache: Dict[int, Tuple] = {}
    oi = target_obj_id - 1
    for tgt in targets:
        if int(tgt["obj_id"]) != target_obj_id:
            continue
        scene_id, im_id = int(tgt["scene_id"]), int(tgt["im_id"])
        if scene_id not in cache:
            scene_dir = os.path.join(dataset_dir, data_folder,
                                     f"{scene_id:06d}")
            scene_cams = load_scene_camera(
                os.path.join(scene_dir, "scene_camera.json"))
            gt_fn = os.path.join(scene_dir, "scene_gt.json")
            gti_fn = os.path.join(scene_dir, "scene_gt_info.json")
            if os.path.exists(gt_fn) and os.path.exists(gti_fn):
                cache[scene_id] = (scene_dir, scene_cams,
                                   load_scene_gt(gt_fn),
                                   load_scene_gt(gti_fn))
            else:
                cache[scene_id] = (scene_dir, scene_cams, None, None)
        scene_dir, scene_cams, scene_gts, scene_gtis = cache[scene_id]
        rgb_fn = _rgb_path(scene_dir, dataset, im_id, train=False)
        if scene_gts is not None:
            for counter, gt in enumerate(scene_gts[im_id]):
                if int(gt["obj_id"]) != target_obj_id:
                    continue
                if scene_gtis[im_id][counter]["visib_fract"] <= 0.1:
                    continue
                rgb[oi].append(rgb_fn)
                mask[oi].append([os.path.join(
                    scene_dir, "mask", f"{im_id:06d}_{counter:06d}.png")])
                maskv[oi].append([os.path.join(
                    scene_dir, "mask_visib",
                    f"{im_id:06d}_{counter:06d}.png")])
                gts[oi].append(gt)
                gtis[oi].append(scene_gtis[im_id][counter])
                cams[oi].append(scene_cams[im_id])
        else:
            rgb[oi].append(rgb_fn)
            mask[oi].append([""])
            maskv[oi].append([""])
            gts[oi].append(None)
            gtis[oi].append(None)
            cams[oi].append(scene_cams[im_id])

    # global camera file (im_size needed by the refiner even when the
    # challenge split ships without GT — tless primesense is 720x540, NOT
    # the 640x480 of camera.json-less datasets)
    cam_global_fn = os.path.join(dataset_dir, _camera_file(dataset))
    cam_global = (load_cam_params(cam_global_fn)
                  if os.path.exists(cam_global_fn) else {})

    return BopSamples(dataset_dir, os.path.join(dataset_dir, data_folder),
                      model_plys, model_info, model_ids, rgb, mask, maskv,
                      gts, gtis, cams, cam_global)


def ycbv_select_keyframes(samples: BopSamples, obj_id: int,
                          keyframe_path: str) -> List[int]:
    """Indices of the object's samples on the YCB-V keyframe list
    (reference get_detection_results.ycbv_select_keyframe; the port's
    copy of JAX `bop_io.py::ycbv_select_keyframes`, which no path
    calls: `run_test` uses `detections.keyframe_indices`)."""
    with open(keyframe_path) as f:
        keyframes = {line.strip() for line in f if line.strip()}
    keep = []
    for i, fn in enumerate(samples.rgb_files[obj_id - 1]):
        parts = fn.split(os.sep)
        scene = int(parts[-3])
        im = int(os.path.splitext(parts[-1])[0])
        if f"{scene:04d}/{im:06d}" in keyframes:
            keep.append(i)
    return keep
