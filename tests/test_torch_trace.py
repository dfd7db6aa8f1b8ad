"""The program's spans (`utils/profiling.py::span`): nothing recorded
while no profiler records; the serving step's and the training step's
stages, in order and nested in their step, while one does.

The recording branch is driven by patching the helper's predicate, so
no profiler starts in this process (its lazy imports trip on the stub
`imgaug` modules that tests/test_real_reference_module.py installs).
The `--profile` trace of `test`, which holds the same ranges, is checked
in tests/test_torch_runner.py, in the command's own interpreter.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads a worker)
from test_torch_trainer import _hide_module_stubs  # noqa: F401  (autouse)
from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
from zebrapose_tpu_torch.data.pipeline import gather_preprocess_batch
from zebrapose_tpu_torch.eval.evaluate import make_eval_step
from zebrapose_tpu_torch.models.losses import CodeLossConfig
from zebrapose_tpu_torch.ops.pnp import PnPConfig
from zebrapose_tpu_torch.train.state import create_train_state
from zebrapose_tpu_torch.train.train_step import train_step
from zebrapose_tpu_torch.utils import profiling

B, H, W, BITS = 2, 48, 64, 8
CROP, GT = 32, 16
# the serving step's own stages, then those of the pose decode it calls
SERVE_LEAVES = ["serve.upload", "serve.preprocess", "serve.forward",
                "serve.binarize", "serve.upload", "decode.correspondences",
                "decode.ransac_prepare", "decode.hypotheses",
                "decode.ransac_finish"]


@pytest.fixture()
def recording(monkeypatch):
    """The spans' predicate reads "a profiler records"; the list starts
    and ends empty."""
    profiling.clear_spans()
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: True)
    yield
    profiling.clear_spans()


def _serve_step(escalate: int = 0):
    rng = np.random.default_rng(0)
    lut = CorrespondenceLUT(rng.uniform(-30, 30, (2 ** BITS, 3))
                            .astype(np.float32),
                            np.ones(2 ** BITS, bool), 2, BITS)
    head = torch.nn.Conv2d(3, 1 + BITS, 1)
    torch.nn.init.normal_(head.weight, std=2.0)

    def forward(batch):
        x = torch.nn.functional.avg_pool2d(
            batch["image"].permute(0, 3, 1, 2), CROP // GT)
        y = head(x).permute(0, 2, 3, 1)
        return {"mask": y[..., :1] + 2.0, "code": y[..., 1:]}

    step = make_eval_step(
        forward, lut, crop_img=CROP, crop_gt=GT, base=2, n_bits=BITS,
        resize_method="crop_square_resize", loss_type="BCE",
        pnp_cfg=PnPConfig(n_hypotheses=8, escalate_hypotheses=escalate,
                          escalate_inlier_frac=1.0),
        preprocess_gt=False, device="cpu")
    feed = {"rgb": torch.from_numpy(rng.integers(0, 255, (B, H, W, 3),
                                                 dtype=np.uint8)),
            "roi_param": np.tile(np.array([[8, 4, 40, 36, 32]], np.int32),
                                 (B, 1)),
            "valid": np.ones(B, np.float32)}
    fb = np.tile(np.array([[8, 4, 40, 36]], np.int32), (B, 1))
    K = np.tile(np.array([[400.0, 0, 32], [0, 400.0, 24], [0, 0, 1]],
                         np.float32), (B, 1, 1))
    return lambda: step(feed, fb, K, generator=torch.Generator()
                        .manual_seed(1))


class _TinyNet(torch.nn.Module):
    """NHWC logits at the crop's half size, as the network gives them."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 2 + BITS, 1)

    def forward(self, x):
        y = self.conv(torch.nn.functional.avg_pool2d(
            x.permute(0, 3, 1, 2), CROP // GT)).permute(0, 2, 3, 1)
        return {"mask": y[..., :1], "entire_mask": y[..., 1:2],
                "code": y[..., 2:]}


def _train_parts():
    g = torch.Generator().manual_seed(0)
    n = 4
    arrays = {"rgb": torch.randint(0, 255, (n, H, W, 3), generator=g,
                                   dtype=torch.uint8),
              "label": torch.randint(0, 255, (n, H, W, 3), generator=g,
                                     dtype=torch.uint8),
              "mask": torch.randint(0, 2, (n, H, W), generator=g,
                                    dtype=torch.uint8) * 255,
              "entire_mask": torch.full((n, H, W), 255, dtype=torch.uint8)}
    idx = np.array([0, 3])
    roi = np.tile(np.array([[8, 4, 40, 36, 32]], np.int32), (B, 1))
    valid = np.ones(B, np.float32)
    state = create_train_state(_TinyNet(), 2e-4, n_bits=BITS)

    def batch():
        return gather_preprocess_batch(
            arrays, idx, roi, valid, torch.Generator().manual_seed(2),
            crop_img=CROP, crop_gt=GT, base=2, n_bits=BITS)

    def step(b):
        return train_step(state, b, CodeLossConfig(n_bits=BITS))
    return batch, step


def _names(prefix):
    return [(n[len(prefix):], t0, t1) for n, _, t0, t1 in profiling.spans()
            if n.startswith(prefix)]


def _leaves_in(spans, outer):
    """The spans other than `outer`, in start order, each inside `outer`
    and ending before the next starts."""
    (o0, o1), = [(t0, t1) for n, t0, t1 in spans if n == outer]
    leaves = sorted((s for s in spans if s[0] != outer), key=lambda s: s[1])
    for (_, a0, a1), (_, b0, _) in zip(leaves, leaves[1:]):
        assert a1 <= b0
    assert all(o0 <= t0 <= t1 <= o1 for _, t0, t1 in leaves)
    return [n for n, _, _ in leaves]


def test_off_path_records_nothing(monkeypatch):
    """With no profiler recording, a serving step and a training step
    record no span, open no profiler range and make no CUDA event."""
    record_function = torch.autograd.profiler.record_function

    def ranges(name, *a, **k):
        # Adam's step opens its own range whether or not one records
        assert not name.startswith("zebrapose."), name
        return record_function(name, *a, **k)

    def refuse(*a, **k):
        raise AssertionError("a CUDA event on the off path")

    profiling.clear_spans()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", ranges)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    _serve_step()()
    batch, step = _train_parts()
    step(batch())
    assert profiling.spans() == []


@pytest.mark.parametrize("escalate", [0, 8])
def test_serving_step_records_its_stages(recording, escalate):
    out = _serve_step(escalate)()
    assert out[0].shape == (B, 3, 3)
    spans = _names("zebrapose.")
    assert [n for n, _, _ in spans].count("serve.step") == 1
    want = SERVE_LEAVES + (["decode.escalation"] if escalate else [])
    assert _leaves_in(spans, "serve.step") == want


def test_training_step_records_its_stages(recording):
    batch, step = _train_parts()
    b = batch()
    assert [n for n, _, _ in _names("zebrapose.train.")] == [
        "upload", "preprocess"]
    profiling.clear_spans()
    m = step(b)
    assert torch.isfinite(m["loss_total"])
    spans = _names("zebrapose.train.")
    assert _leaves_in(spans, "step") == ["forward", "loss", "backward",
                                         "optimizer"]


def test_span_adds_to_a_clock_without_a_profiler():
    profiling.clear_spans()
    clock = {"wait_s": 0.0}
    with profiling.span("zebrapose.run.wait_s", clock):
        sum(range(1000))
    with profiling.span("zebrapose.run.wait_s", None):
        pass
    assert clock["wait_s"] > 0 and profiling.spans() == []


MODEL_SPANS = ["model.backbone", "model.decoder"]


def _model(variant):
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    torch.manual_seed(3)
    return ZebraPoseNet(binary_code_length=BITS, variant=variant).eval()


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_model_forward_records_backbone_then_decoder(recording, variant):
    """One forward (v3: both decoders under one span) records the
    backbone's span and then the decoder's, once each, the second
    starting after the first ended."""
    with torch.no_grad():
        out = _model(variant)(torch.randn(2, 64, 64, 3))
    assert out["code"].shape == (2, 32, 32, BITS)
    spans = sorted(_names("zebrapose."), key=lambda s: s[1])
    assert [n for n, _, _ in spans] == MODEL_SPANS
    (_, _, b1), (_, d0, _) = spans
    assert b1 <= d0


def test_model_forward_records_nothing_without_a_profiler():
    profiling.clear_spans()
    assert not torch.autograd._profiler_enabled()
    with torch.no_grad():
        _model("v2")(torch.randn(1, 64, 64, 3))
    assert profiling.spans() == []


@pytest.mark.parametrize("records", [False, True])
def test_fleet_vmapped_forward_runs_with_the_spans(monkeypatch, records):
    """The fleet's vmapped forward (`eval/fleet_serve.py`) runs through
    the model's spans with and without a recording profiler, gives each
    member's own forward, and records the spans once for the K members."""
    from zebrapose_tpu_torch.eval import fleet_serve as tfs

    profiling.clear_spans()
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: records)
    nets = [_model("v2") for _ in range(2)]
    for k, net in enumerate(nets):
        torch.manual_seed(10 + k)
        for p in net.parameters():
            p.data.normal_(0.0, 0.05)
    with torch.device("meta"):
        template = _model("v2")
    keep = [n for n, _ in template.named_parameters()] + \
        [n for n, _ in template.named_buffers()]
    variables = tfs.stack_variables(
        [{n: v for n, v in net.state_dict().items() if n in keep}
         for net in nets], "cpu")
    x = torch.randn(2, 2, 64, 64, 3, generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        got = torch.func.vmap(tfs.model_forward(template))({"image": x},
                                                           variables)
    assert [n for n, _, _ in _names("zebrapose.")] == \
        (MODEL_SPANS if records else [])
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    with torch.no_grad():
        for k, net in enumerate(nets):
            for name, v in net(x[k]).items():
                torch.testing.assert_close(got[name][k], v, atol=2e-4,
                                           rtol=0)
    profiling.clear_spans()
