"""The readers of the program's stage spans (`metrics/_spans.py`): host
ms a step from a list of spans, nothing without a profile or without
spans to read, and an error where the steps lack a stage's span."""

from __future__ import annotations

import pytest

from benchmark import harness

SERVE = ["upload", "preprocess", "forward", "ransac_prepare",
         "ransac_finish"]
# the stages the pose decode (ops/pnp.py) opens, named by its own layer
DECODE = {"correspondences", "ransac_prepare", "hypotheses",
          "ransac_finish", "escalation"}
TRAIN = ["upload", "preprocess", "forward", "loss", "backward", "optimizer"]
READERS = [f"{s}_host_ms.serve" for s in SERVE] + \
    [f"{s}_host_ms.train" for s in TRAIN]


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py",
                               "m_" + name.replace(".", "_"))


def _name(path, stage):
    layer = "decode" if path == "serve" and stage in DECODE else path
    return f"zebrapose.{layer}.{stage}"


def _spans(path, steps, stages_ms):
    """`steps` steps of `zebrapose.<path>`, each holding its stages one
    after another with the given ms (a stage listed twice spans twice)."""
    out, t = [], 0
    for _ in range(steps):
        t0 = t
        for stage, ms in stages_ms:
            out.append((_name(path, stage), 1, t, t + int(ms * 1e6)))
            t += int(ms * 1e6)
        out.append((f"zebrapose.{path}.step", 1, t0, t))
        # a span of another path, and the run loop's, are not read
        out.append(("zebrapose.run.step_s", 1, t0, t))
    return out


@pytest.fixture
def recorded(monkeypatch):
    from zebrapose_tpu_torch.utils import profiling

    def put(spans):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    return put


def test_serve_stage_ms_a_batch(recorded):
    recorded(_spans("serve", 4, [("upload", 30), ("preprocess", 2),
                                 ("forward", 5), ("binarize", 1),
                                 ("upload", 10), ("correspondences", 1),
                                 ("ransac_prepare", 7), ("hypotheses", 1),
                                 ("ransac_finish", 60)]))
    run = {"profile": {"batches": 4}}
    want = {"upload": 40, "preprocess": 2, "forward": 5,
            "ransac_prepare": 7, "ransac_finish": 60}
    for stage in SERVE:
        got = _reader(f"{stage}_host_ms.serve").read(run)
        assert got == pytest.approx(want[stage]), stage


def test_train_stage_ms_a_step(recorded):
    spans = _spans("train", 3, [("forward", 12), ("loss", 3),
                                ("backward", 9), ("optimizer", 8)])
    # the input's spans lie outside the step, one pair a step
    spans += [("zebrapose.train.upload", 1, 0, 400_000)] * 3
    spans += [("zebrapose.train.preprocess", 1, 0, 2_000_000)] * 3
    recorded(spans)
    run = {"profile": {"batches": 3}}
    want = {"upload": 0.4, "preprocess": 2, "forward": 12, "loss": 3,
            "backward": 9, "optimizer": 8}
    for stage in TRAIN:
        got = _reader(f"{stage}_host_ms.train").read(run)
        assert got == pytest.approx(want[stage]), stage


@pytest.mark.parametrize("name", READERS)
def test_nothing_without_a_profile(recorded, name):
    recorded(_spans("serve", 2, [(s, 1) for s in SERVE])
             + _spans("train", 2, [(s, 1) for s in TRAIN]))
    reader = _reader(name)
    assert reader.read({}) is None
    assert reader.read({"profile": None}) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_from_a_program_without_spans(monkeypatch, name):
    """A program that keeps no spans (an older tree) gives no value and
    does not raise; neither does an empty list or one without steps."""
    from zebrapose_tpu_torch.utils import profiling

    run = {"profile": {"batches": 2}}
    reader = _reader(name)
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader.read(run) is None
    path, stage = name.split(".")[1], name.split("_host_ms")[0]
    monkeypatch.setattr(profiling, "spans", lambda: [
        (_name(path, stage), 1, 0, 10)])
    assert reader.read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(run) is None


@pytest.mark.parametrize("name", READERS)
def test_steps_without_the_stage_raise(recorded, name):
    """Where the program records its steps but not the stage (a span
    renamed or moved), the reader fails instead of falling silent."""
    path, stage = name.split(".")[1], name.split("_host_ms")[0]
    stages = SERVE if path == "serve" else TRAIN
    recorded(_spans(path, 2, [(s, 1) for s in stages if s != stage]))
    with pytest.raises(harness.BenchError, match=_name(path, stage)):
        _reader(name).read({"profile": {"batches": 2}})
