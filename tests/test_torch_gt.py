"""The port's offline GT generation against the JAX package's: the native
partitioner (vertex classes, face classes, centroids), the surface-code
text and colored mesh, symmetry canonicalization, the rendered label
images of a split, and the `generate-mesh-code` / `generate-labels`
commands. Everything here is host work in both stacks (numpy and each
package's build of the same C++), so the results are held equal.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

from zebrapose_tpu import native as jnative
from zebrapose_tpu.data.bop_io import save_ply as j_save_ply
from zebrapose_tpu.tools import symmetry as jsym
from zebrapose_tpu.tools.generate_gt import (
    generate_mesh_surface_code as j_generate_mesh_surface_code,
)
from zebrapose_tpu.tools.label_driver import (
    generate_labels_cli as j_generate_labels_cli,
)
from zebrapose_tpu_torch import native
from zebrapose_tpu_torch.config import ZebraConfig
from zebrapose_tpu_torch.tools import symmetry
from zebrapose_tpu_torch.tools.generate_gt import generate_mesh_surface_code
from zebrapose_tpu_torch.tools.label_driver import generate_labels_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh(rng, n_vertices, n_faces):
    pts = rng.normal(0, 30, (n_vertices, 3)).astype(np.float32)
    faces = rng.integers(0, n_vertices, (n_faces, 3)).astype(np.int32)
    return pts, faces


@pytest.mark.parametrize("d,n,seed", [(2, 6, 0), (2, 9, 7), (3, 4, 1),
                                      (4, 3, 2)])
def test_partition_face_classes_centroids_equal_jax(d, n, seed):
    rng = np.random.default_rng(seed)
    pts, faces = _mesh(rng, d ** n + 37, 3000)
    vc = native.partition_mesh(pts, d, n, seed=seed)
    np.testing.assert_array_equal(
        vc, jnative.partition_mesh(pts, d, n, seed=seed))
    assert vc.dtype == np.uint32 and vc.max() < d ** n
    # balanced: every class holds floor or ceil of V / d^n vertices
    counts = np.bincount(vc, minlength=d ** n)
    assert counts.min() >= len(pts) // d ** n and \
        counts.max() <= -(-len(pts) // d ** n)
    np.testing.assert_array_equal(native.face_classes(vc, faces),
                                  jnative.face_classes(vc, faces))
    np.testing.assert_array_equal(
        native.class_centroids(pts, vc, d ** n + 5),
        jnative.class_centroids(pts, vc, d ** n + 5))


def test_partition_of_the_sphere_equals_jax():
    import chip_smoke

    pts, faces = chip_smoke.uv_sphere()
    vc = native.partition_mesh(pts, 2, 16, seed=0)
    np.testing.assert_array_equal(vc, jnative.partition_mesh(pts, 2, 16,
                                                             seed=0))
    np.testing.assert_array_equal(native.face_classes(vc, faces),
                                  jnative.face_classes(vc, faces))
    np.testing.assert_array_equal(native.class_centroids(pts, vc, 2 ** 16),
                                  jnative.class_centroids(pts, vc, 2 ** 16))


def test_bindings_check_their_arguments():
    pts = np.zeros((8, 3), np.float32)
    with pytest.raises(ValueError, match="vertices"):
        native.partition_mesh(np.zeros((8, 2), np.float32), 2, 2)
    with pytest.raises(ValueError, match="uint32"):
        native.partition_mesh(pts, 2, 33)
    with pytest.raises(ValueError, match="faces"):
        native.face_classes(np.zeros(8, np.uint32), np.array([[0, 1, 8]]))
    with pytest.raises(ValueError, match="one class a vertex"):
        native.class_centroids(pts, np.zeros(7, np.uint32), 4)


def test_surface_code_text_and_colored_mesh_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    pts, faces = _mesh(rng, 600, 1100)
    mesh = str(tmp_path / "m.ply")
    j_save_ply(mesh, pts, faces=faces)
    out = {}
    for who, fn in (("jax", j_generate_mesh_surface_code),
                    ("port", generate_mesh_surface_code)):
        lut, face_class = fn(mesh, 2, 9, str(tmp_path / who / "c.txt"),
                             str(tmp_path / who / "c.ply"), seed=4)
        out[who] = (lut, face_class)
        assert lut.valid.sum() == 512
    for name in ("c.txt", "c.ply"):
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    np.testing.assert_array_equal(out["jax"][1], out["port"][1])
    with pytest.raises(ValueError, match="upsample"):
        generate_mesh_surface_code(mesh, 2, 10, str(tmp_path / "x.txt"))


def test_committed_lut_is_the_port_partition_of_the_sphere(tmp_path):
    """trained/rehearsal3_lut.npz (made by the JAX package on this
    toolchain) is what the port's generate_mesh_surface_code gives."""
    import chip_smoke
    from zebrapose_tpu_torch.data.bop_io import save_ply

    pts, faces = chip_smoke.uv_sphere()
    save_ply(str(tmp_path / "sphere.ply"), pts, faces=faces)
    lut, _ = generate_mesh_surface_code(str(tmp_path / "sphere.ply"), 2, 16,
                                        str(tmp_path / "lut.txt"), seed=0)
    with np.load(chip_smoke.LUT) as z:
        np.testing.assert_array_equal(z["points"], lut.points)
        np.testing.assert_array_equal(z["valid"], lut.valid)
        assert hashlib.sha256((tmp_path / "lut.txt").read_bytes()) \
            .hexdigest() == str(z["text_sha256"])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


@pytest.mark.parametrize("kind", ["none", "discrete", "z", "y", "x",
                                  "combined"])
def test_canonicalize_pose_equals_jax(kind):
    flip = np.eye(4)
    flip[:3, :3] = np.diag([1.0, -1.0, -1.0])
    flip[:3, 3] = [0, 0, 5.0]
    quarter = np.eye(4)
    quarter[:3, :3] = _rot_z(np.pi / 2)
    axis = {"x": [1, 0, 0], "y": [0, 1, 0], "z": [0, 0, 1],
            "combined": [0, 0, 1]}
    info = {}
    if kind in axis:
        info["symmetries_continuous"] = [{"axis": axis[kind],
                                          "offset": [0, 0, 0]}]
    if kind == "combined":
        info["symmetries_discrete"] = [flip.reshape(-1).tolist()]
    if kind == "discrete":
        info["symmetries_discrete"] = [quarter.reshape(-1).tolist(),
                                       flip.reshape(-1).tolist()]
    rng = np.random.default_rng(5)
    for _ in range(50):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        t = rng.normal(0, 100, 3)
        got = symmetry.canonicalize_pose(R, t, info)
        want = jsym.canonicalize_pose(R, t, info)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("info,match", [
    ({"symmetries_continuous": [{"axis": [0, 0, 1]}, {"axis": [0, 1, 0]}]},
     "multiple continuous"),
    ({"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 1]}]},
     "offset"),
    ({"symmetries_discrete": [np.eye(4).reshape(-1).tolist()],
      "symmetries_continuous": [{"axis": [1, 0, 0], "offset": [0, 0, 0]}]},
     "non-z"),
    ({"symmetries_continuous": [{"axis": [1, 1, 0], "offset": [0, 0, 0]}]},
     "axis")])
def test_canonicalize_pose_refusals_as_jax(info, match):
    for fn in (symmetry.canonicalize_pose, jsym.canonicalize_pose):
        with pytest.raises(NotImplementedError, match=match):
            fn(np.eye(3), np.zeros(3), info)


@pytest.fixture(scope="module")
def three_frames(tmp_path_factory):
    """chip_smoke's phase-7 tree at 3 frames (the committed surface code
    in models_GT_color)."""
    import chip_smoke

    root = tmp_path_factory.mktemp("tree")
    cfg_path, _, _ = chip_smoke.write_tree(str(root), n_frames=3)
    return str(root), cfg_path


def _label_ids(folder):
    """{name: class ids [H, W]} of a _GT_v2 scene folder, decoded with
    cv2."""
    out = {}
    for name in sorted(os.listdir(folder)):
        bgr = cv2.imread(os.path.join(folder, name)).astype(np.int64)
        out[name] = (bgr[..., 0] << 16) | (bgr[..., 1] << 8) | bgr[..., 2]
    return out


@pytest.mark.parametrize("symmetric", [False, True],
                         ids=["plain", "continuous_z"])
def test_generate_labels_equals_jax(three_frames, tmp_path, symmetric):
    from zebrapose_tpu.config import ZebraConfig as JConfig

    src, cfg_path = three_frames
    trees = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        shutil.copytree(src, root)
        info = root / "lmo" / "models" / "models_info.json"
        if symmetric:
            d = json.loads(info.read_text())
            d["1"]["symmetries_continuous"] = [{"axis": [0, 0, 1],
                                                "offset": [0, 0, 0]}]
            info.write_text(json.dumps(d))
        text = open(cfg_path).read().replace(src, str(root))
        (root / "cfg.txt").write_text(text)
        trees[who] = root
    n_j = j_generate_labels_cli(
        JConfig.from_file(str(trees["jax"] / "cfg.txt")), "ape", "test")
    n_p = generate_labels_cli(
        ZebraConfig.from_file(str(trees["port"] / "cfg.txt")), "ape", "test")
    assert n_j == n_p == 3
    got = _label_ids(trees["port"] / "lmo" / "test_GT_v2" / "000001")
    want = _label_ids(trees["jax"] / "lmo" / "test_GT_v2" / "000001")
    assert sorted(got) == sorted(want) == [f"{i:06d}_000000.png"
                                           for i in range(3)]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        assert (got[name] > 0).sum() > 1000
    if symmetric:
        # the committed reference poses chip_smoke's phase 10 falls back
        # on: the first frames' canonical poses, as made here
        with open(trees["port"] / "lmo" / "test" / "000001" /
                  "scene_gt.json") as f:
            gt = json.load(f)
        ref = np.load(os.path.join(REPO, "tests", "data", "torch_images",
                                   "sphere_sym_poses.npz"))
        info = {"symmetries_continuous": [{"axis": [0, 0, 1],
                                           "offset": [0, 0, 0]}]}
        for i in range(3):
            R, t = symmetry.canonicalize_pose(
                np.array(gt[str(i)][0]["cam_R_m2c"]).reshape(3, 3),
                np.array(gt[str(i)][0]["cam_t_m2c"]), info)
            np.testing.assert_array_equal(ref["R"][i], R)
            np.testing.assert_array_equal(ref["t"][i], t.reshape(3))
        return
    # skip-existing; then force without the surface code: the code is
    # made anew and the rewrite gives the same labels
    port_cfg = ZebraConfig.from_file(str(trees["port"] / "cfg.txt"))
    assert generate_labels_cli(port_cfg, "ape", "test") == 0
    os.remove(trees["port"] / "lmo" / "models_GT_color" /
              "Class_CorresPoint000001.txt")
    assert generate_labels_cli(port_cfg, "ape", "test", force=True) == 3
    for name, ids in _label_ids(
            trees["port"] / "lmo" / "test_GT_v2" / "000001").items():
        np.testing.assert_array_equal(ids, want[name])


def test_load_obj_equals_jax(tmp_path):
    from zebrapose_tpu.tools.generate_gt import load_obj as j_load_obj
    from zebrapose_tpu_torch.tools.generate_gt import load_obj

    p = tmp_path / "m.obj"
    p.write_text("# a quad, a pentagon and a triangle\n"
                 + "".join(f"v {i} {i * 0.5} {-i}\nvn 0 0 1\n"
                           for i in range(7))
                 + "f 1/1/1 2/2/2 3/3/3 4/4/4\n\nf 2 3 4 5 6\nf 5//1 6//1 7//1\n")
    got, want = load_obj(str(p)), j_load_obj(str(p))
    for k in ("pts", "faces"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert len(got["faces"]) == 2 + 3 + 1


def test_generate_labels_prefers_the_obj_mesh(three_frames, tmp_path):
    """With `models/obj_000001.obj` beside the PLY (an upsampled mesh in
    the reference recipe; here the sphere at half size), both packages
    re-partition and render the OBJ, and agree."""
    from zebrapose_tpu.config import ZebraConfig as JConfig
    import chip_smoke

    src, cfg_path = three_frames
    pts, faces = chip_smoke.uv_sphere()
    ids = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        shutil.copytree(src, root)
        with open(root / "lmo" / "models" / "obj_000001.obj", "w") as f:
            f.writelines(f"v {x} {y} {z}\n" for x, y, z in pts * 0.5)
            f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
        (root / "cfg.txt").write_text(
            open(cfg_path).read().replace(src, str(root)))
        fn, cfg = ((j_generate_labels_cli, JConfig) if who == "jax" else
                   (generate_labels_cli, ZebraConfig))
        assert fn(cfg.from_file(str(root / "cfg.txt")), "ape", "test") == 3
        ids[who] = _label_ids(root / "lmo" / "test_GT_v2" / "000001")
    for name, want in ids["jax"].items():
        np.testing.assert_array_equal(ids["port"][name], want)
    # half the radius: about a quarter of the full sphere's pixels
    assert 0 < (want > 0).sum() < 0.4 * np.pi * (40 * 570 / 480) ** 2


def test_cli_commands_in_a_subprocess(three_frames, tmp_path):
    """`generate-mesh-code` and `generate-labels` as users run them: a
    fresh interpreter, no --device."""
    src, cfg_path = three_frames
    rng = np.random.default_rng(6)
    pts, faces = _mesh(rng, 300, 500)
    mesh = str(tmp_path / "m.ply")
    j_save_ply(mesh, pts, faces=faces)
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(*args):
        res = subprocess.run([sys.executable, "-m", "zebrapose_tpu_torch",
                              *args], cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        return res.stdout

    out = run("generate-mesh-code", "--mesh", mesh, "-d", "2", "-n", "8",
              "--corres_txt", str(tmp_path / "port.txt"))
    assert "256 classes, 256 non-empty" in out
    j_generate_mesh_surface_code(mesh, 2, 8, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    root = tmp_path / "tree"
    shutil.copytree(src, root)
    cfg = root / "cfg.txt"
    cfg.write_text(open(cfg_path).read().replace(src, str(root)))
    out = run("generate-labels", "--cfg", str(cfg), "--obj_name", "ape",
              "--data_folder", "test")
    assert "wrote 3 label images" in out
    assert len(os.listdir(root / "lmo" / "test_GT_v2" / "000001")) == 3
