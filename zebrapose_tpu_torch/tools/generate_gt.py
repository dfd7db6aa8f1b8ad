"""Offline GT generation (layer L0 of SURVEY.md): surface code and label
images.

Port of `zebrapose_tpu/tools/generate_gt.py`, on the port's copy of the
native library (`zebrapose_tpu_torch/native`), LUT writer, PLY reader /
writer and PNG writer; numpy and C++ on the host in both stacks, no
device.

1. `generate_mesh_surface_code`: mesh -> hierarchical surface encoding —
   `Class_CorresPoint<obj>.txt` (class id -> region centroid) and a
   colored mesh PLY whose per-face RGB encodes the class id
   (B<<16|G<<8|R with duplicated vertices so faces stay uniform), the
   same artifacts as Generate_Mesh_with_GT_Color.cpp:541-632.

2. `generate_labels_for_split`: renders a per-instance label PNG for
   every GT instance of an object across a BOP split into
   `<split>_GT_v2/<scene>/<im>_<inst>.png`, canonicalizing the pose
   w.r.t. object symmetries first (generate_training_labels_for_BOP_v2).
   Skip-existing gives cheap resume (force_rewrite=False semantics). The
   PNG rows carry the Sub filter, as cv2.imwrite writes them; the bytes
   may differ from cv2's (zlib level), the pixels do not.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from zebrapose_tpu_torch import native
from zebrapose_tpu_torch.codec.lut import (
    CorrespondenceLUT,
    save_correspondence_lut,
)
from zebrapose_tpu_torch.data import png
from zebrapose_tpu_torch.data.bop_io import load_ply, save_ply
from zebrapose_tpu_torch.tools.symmetry import canonicalize_pose


def load_obj(path: str) -> Dict[str, np.ndarray]:
    """Minimal OBJ reader: v/f lines, polygon fan-triangulation."""
    pts, faces = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                pts.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "f":
                idx = [int(t.split("/")[0]) - 1 for t in tok[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return {"pts": np.array(pts, np.float64),
            "faces": np.array(faces, np.int64)}


def load_mesh(path: str) -> Dict[str, np.ndarray]:
    if path.lower().endswith(".obj"):
        return load_obj(path)
    return load_ply(path)


def class_id_to_bgr(ids: np.ndarray) -> np.ndarray:
    """id -> (B, G, R) uint8 triplets (class_id_to_RGB_value contract)."""
    ids = ids.astype(np.int64)
    return np.stack([(ids >> 16) & 255, (ids >> 8) & 255, ids & 255],
                    axis=-1).astype(np.uint8)


def generate_mesh_surface_code(mesh_path: str, divide_number: int,
                               n_levels: int, corres_txt_path: str,
                               colored_ply_path: Optional[str] = None,
                               seed: int = 0
                               ) -> Tuple[CorrespondenceLUT, np.ndarray]:
    """Partition a mesh and write the correspondence table (+ colored
    mesh). Returns (lut, per-face class ids)."""
    mesh = load_mesh(mesh_path)
    pts = mesh["pts"].astype(np.float32)
    faces = mesh["faces"].astype(np.int32)
    n_classes = divide_number ** n_levels
    if len(pts) < n_classes:
        raise ValueError(
            f"mesh has {len(pts)} vertices < {n_classes} classes; "
            "upsample the mesh first (reference requires > d^n vertices)")

    vertex_class = native.partition_mesh(pts, divide_number, n_levels,
                                         seed=seed)
    face_class = native.face_classes(vertex_class, faces)
    centroids = native.class_centroids(pts, vertex_class, n_classes)

    valid = ~np.isnan(centroids).any(axis=1)
    lut = CorrespondenceLUT(
        points=np.where(valid[:, None], centroids, 0).astype(np.float32),
        valid=valid, base=divide_number, n_digits=n_levels)
    os.makedirs(os.path.dirname(os.path.abspath(corres_txt_path)),
                exist_ok=True)
    save_correspondence_lut(corres_txt_path, lut)

    if colored_ply_path is not None:
        # duplicate vertices per face so each face renders one flat color
        tri = pts[faces.reshape(-1)]
        colors = np.repeat(class_id_to_bgr(face_class), 3, axis=0)
        # PLY convention: (red, green, blue) columns
        rgb = colors[:, ::-1]
        new_faces = np.arange(len(tri)).reshape(-1, 3)
        save_ply(colored_ply_path, tri, rgb, new_faces)

    return lut, face_class


def render_label_image(mesh_pts: np.ndarray, mesh_faces: np.ndarray,
                       face_class: np.ndarray, K: np.ndarray,
                       R: np.ndarray, t: np.ndarray, width: int,
                       height: int,
                       model_info: Optional[dict] = None) -> np.ndarray:
    """Render one GT label image (BGR uint8, pixel = class id of the
    visible face), canonicalizing the pose if symmetries are given."""
    if model_info is not None:
        R, t = canonicalize_pose(R, t, model_info)
    ids, _ = native.render_label(mesh_pts, mesh_faces,
                                 face_class.astype(np.int32), K,
                                 np.asarray(R), np.asarray(t).reshape(3),
                                 width, height)
    return class_id_to_bgr(ids)


def generate_labels_for_split(samples, obj_id: int, mesh_pts, mesh_faces,
                              face_class, width: int, height: int,
                              model_info: Optional[dict] = None,
                              gt_dir_suffix: str = "_GT_v2",
                              data_folder: str = "test",
                              force_rewrite: bool = False) -> int:
    """Render label PNGs for every sample of `obj_id` in a BopSamples
    split. Returns the number of images written."""
    rgb, mask, maskv, gts, gtis, cams = samples.for_obj(obj_id)
    written = 0
    for i, rgb_fn in enumerate(rgb):
        scene_id = rgb_fn.split("/")[-3]
        name = os.path.basename(maskv[i][0])
        out_dir = os.path.join(samples.dataset_dir,
                               data_folder + gt_dir_suffix, scene_id)
        os.makedirs(out_dir, exist_ok=True)
        out_fn = os.path.join(out_dir, name)
        if os.path.exists(out_fn) and not force_rewrite:
            continue
        gt = gts[i]
        label = render_label_image(
            mesh_pts, mesh_faces, face_class,
            np.asarray(cams[i]["cam_K"], np.float64).reshape(3, 3),
            np.asarray(gt["cam_R_m2c"]), np.asarray(gt["cam_t_m2c"]),
            width, height, model_info)
        png.imwrite(out_fn, label)
        written += 1
    return written
