"""Label-generation driver: mesh surface code + GT_v2 labels for one
object over a BOP split (generate_training_labels_for_BOP_v2 driver).

Port of `zebrapose_tpu/tools/label_driver.py` (`generate_labels_cli`):
host work (numpy and the port's C++ library), no device.
"""

from __future__ import annotations

import os

import numpy as np

from zebrapose_tpu_torch import native
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.data import bop_io
from zebrapose_tpu_torch.data.dataset_info import lookup_obj_id
from zebrapose_tpu_torch.tools.generate_gt import (
    generate_labels_for_split,
    generate_mesh_surface_code,
    load_mesh,
)


def generate_labels_cli(cfg: ZebraConfig, obj_name: str,
                        data_folder: str, force: bool = False) -> int:
    """Ensure the surface code exists for the object's mesh, then render
    GT_v2 labels for every instance in the split."""
    obj_id = lookup_obj_id(cfg.dataset_name, obj_name)
    dataset_dir = os.path.join(cfg.bop_path, cfg.dataset_name)

    corres = os.path.join(dataset_dir, "models_GT_color",
                          f"Class_CorresPoint{obj_id:06d}.txt")
    mesh_path = os.path.join(dataset_dir, "models",
                             f"obj_{obj_id:06d}.ply")
    obj_path = mesh_path[:-4] + ".obj"
    if os.path.exists(obj_path):
        mesh_path = obj_path  # prefer the upsampled OBJ when present

    mesh = load_mesh(mesh_path)
    pts = mesh["pts"].astype(np.float32)
    faces = mesh["faces"].astype(np.int32)

    if not os.path.exists(corres) or force:
        _, face_class = generate_mesh_surface_code(
            mesh_path, cfg.divide_number_each_itration,
            cfg.number_of_itration, corres,
            colored_ply_path=os.path.join(
                dataset_dir, "models_GT_color",
                f"obj_{obj_id:06d}.ply"))
    else:
        # re-derive face classes from the stored correspondence table by
        # re-partitioning deterministically (same seed)
        vc = native.partition_mesh(pts, cfg.divide_number_each_itration,
                                   cfg.number_of_itration, seed=0)
        face_class = native.face_classes(vc, faces)

    samples = bop_io.get_dataset(
        cfg.bop_path, cfg.dataset_name, train=True,
        data_folder=data_folder,
        train_obj_visible_theshold=cfg.train_obj_visible_theshold)
    model_info = samples.model_info.get(str(obj_id), {})
    w, h = samples.cam_param_global["im_size"]
    return generate_labels_for_split(
        samples, obj_id, pts, faces, face_class, w, h,
        model_info=model_info, data_folder=data_folder,
        force_rewrite=force)
