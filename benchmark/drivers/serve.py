"""Offline pose serving: batches of detector crops through the port's
eval step (`eval/evaluate.py::make_eval_step`, the program that `test`
runs and `export-serving` wraps), closed loop with two batches in
flight, as `run_inference` issues them.

Traffic (`traffic/<name>.json`): `batch` crops a batch, each a 480x640
BGR frame in pinned host memory and a detection of the object in it.
Set-up renders `pool_frames` frames on the device from the seed and
fills `ring` pinned batch buffers with `batch` of them each (drawn
without repetition); batch k sends buffer k mod `ring` to the card with
its own detections (GT boxes jittered by up to 3 px, `scaled_share` of
them scaled 1.2x) and its own RANSAC draws, both from (seed, k).
`warmup_batches` run before the window. `capture` batches, drawn from
the seed among [`capture_from`, `capture_from` + `capture_span`) of the
window, keep what each stage produced for the comparison with the
reference after the window (`checks.py`). With --trace 1, CUDA events
time each batch's forward and decode, and torch.profiler covers
`profile_batches` batches from the window's `profile_from`-th on.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import checks, flops, harness, scene
from benchmark.reference import pnp as ref_pnp


def seed_words(seed: int, *more: int) -> List[int]:
    """The seed (any whole number) and stream ids as numpy seed words."""
    return [int(seed) % (1 << 64)] + [int(m) for m in more]


def torch_seed(seed: int, *more: int) -> int:
    """A 63-bit torch seed from the seed and stream ids."""
    return int(np.random.default_rng(seed_words(seed, *more)).integers(
        0, 2 ** 63 - 1))


def build_model(cfg: dict, device, quant=None):
    """The configuration's network as `test` / `export-serving` build
    it: the committed checkpoint (strict), eval mode, channels-last, in
    the serving dtype; `quant` overrides the configuration's int8
    mode."""
    from zebrapose_tpu_torch.eval.runner import load_model_variables
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet

    net = cfg["network"]
    model = ZebraPoseNet(
        binary_code_length=net["code_bits"], base=net["base"],
        variant=net["variant"], resnet_layers=net["resnet_layers"],
        concat=net["concat_encoder_decoder"],
        output_kernel_size=net["output_kernel_size"],
        quant=bool(cfg.get("int8", False)) if quant is None else quant)
    model.load_state_dict(load_model_variables(
        str(harness.ROOT / cfg["checkpoint"]), net["variant"],
        resnet_layers=net["resnet_layers"]), strict=True)
    return model.eval().to(device).to(memory_format=torch.channels_last).to(
        getattr(torch, cfg["serve_dtype"]))


class Server:
    """The system under test: the model and the eval step built from the
    configuration, as a deployment builds them."""

    def __init__(self, cfg: dict, device):
        from zebrapose_tpu_torch.codec.lut import CorrespondenceLUT
        from zebrapose_tpu_torch.eval.evaluate import make_eval_step
        from zebrapose_tpu_torch.ops.pnp import PnPConfig

        self.cfg, self.dev = cfg, device
        net, s = cfg["network"], cfg["shapes"]
        self.int8 = bool(cfg.get("int8", False))
        if device.type == "cuda":
            from zebrapose_tpu_torch.ops import _build
            _build.build(["epnp_minimal"]
                         + (["int8_conv"] if self.int8 else []))
        self.model = build_model(cfg, device)
        self.dtype = getattr(torch, cfg["serve_dtype"])
        with np.load(harness.ROOT / cfg["lut"]) as z:
            lut = CorrespondenceLUT(z["points"], z["valid"], int(z["base"]),
                                    int(z["n_digits"]))
        # what the harness's forward_fn records for the current batch
        self.rec: Dict = {}
        self.step = make_eval_step(
            self._forward, lut, crop_img=s["crop_img"],
            crop_gt=s["crop_gt"], base=net["base"], n_bits=net["code_bits"],
            resize_method=s["resize_method"], loss_type=net["loss_type"],
            pnp_cfg=PnPConfig(**cfg["pnp"]), return_codes=True,
            preprocess_gt=False, device=device)

    def _forward(self, batch):
        rec = self.rec
        img = batch["image"]
        if "fwd" in rec:
            rec["fwd"][0].record()
        out = self.model(img.to(self.dtype))
        if "fwd" in rec:
            rec["fwd"][1].record()
        if "capture" in rec:
            rec["capture"]["crop"] = img
            rec["capture"]["logits"] = out
        return out


class Traffic:
    """One seed's batches: the pinned frame buffers and, for batch k, its
    detections and RANSAC draws."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device):
        s = cfg["shapes"]
        self.seed, self.dev, self.tr = seed, device, tr
        self.pnp = ref_pnp.PnPConfig(**cfg["pnp"])
        self.P = s["crop_gt"] ** 2
        self.B = int(tr["batch"])
        self.padding = float(s["padding_ratio"])
        self.K = np.tile(scene.K_LMO[None], (self.B, 1, 1))
        self.valid = np.ones((self.B,), np.float32)
        g = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
        pool = scene.render(g, int(tr["pool_frames"]), device)
        self.ring_rgb, self.ring_bbox = [], []
        for _ in range(int(tr["ring"])):
            idx = torch.randperm(pool["rgb"].shape[0], generator=g,
                                 device=device)[:self.B]
            rgb = pool["rgb"][idx].cpu()
            self.ring_rgb.append(rgb.pin_memory() if device.type == "cuda"
                                 else rgb)
            self.ring_bbox.append(pool["bbox"][idx].cpu().numpy())
        del pool

    def batch(self, k: int):
        """Batch k's host feed, final bboxes and RANSAC draws."""
        from zebrapose_tpu_torch.ops.pnp import RansacDraws

        r = k % len(self.ring_rgb)
        rng = np.random.default_rng(seed_words(self.seed, 2, k))
        det = scene.detections(self.ring_bbox[r], rng,
                               float(self.tr["scaled_share"]))
        roi, fb = scene.crop_params(det, self.padding)
        g = torch.Generator(device=self.dev).manual_seed(
            torch_seed(self.seed, 3, k))
        n_pad = ref_pnp.subset_pad_len(self.P, self.pnp)
        prio = torch.rand((self.B, n_pad), generator=g, device=self.dev)
        u = torch.rand((self.B, self.pnp.n_hypotheses, self.pnp.sample_size),
                       generator=g, device=self.dev)
        feed = {"rgb": self.ring_rgb[r], "roi_param": roi,
                "valid": self.valid}
        return feed, fb, RansacDraws(prio=prio, u=u)


@contextlib.contextmanager
def hypotheses_kept(cap: dict):
    """While open, the hypothesis stage's inputs and outputs go into
    `cap`: the port's `minimal_epnp_hypotheses` (which its decode looks
    up at each call) is wrapped by one that keeps them."""
    from zebrapose_tpu_torch.ops import pnp_kernel

    orig = pnp_kernel.minimal_epnp_hypotheses

    def keep(samp3d, samp2d, Ks, gn_iters=5):
        Rs, ts = orig(samp3d, samp2d, Ks, gn_iters)
        cap.update(samp3d=samp3d, samp2d=samp2d, Ks=Ks, Rs=Rs, ts=ts)
        return Rs, ts

    keep.launches = orig.launches
    pnp_kernel.minimal_epnp_hypotheses = keep
    try:
        yield
    finally:
        pnp_kernel.minimal_epnp_hypotheses = orig
        orig.launches = keep.launches


@contextlib.contextmanager
def int8_rows_kept(model, rows: List[dict]):
    """While open, forward hooks on the quantized convs keep two rows of
    each one's input and output and the whole input's absmax."""
    from zebrapose_tpu_torch.models.layers import quantized_convs

    def make(name):
        def hook(mod, inp, out):
            x = inp[0]
            rows.append({"name": name, "x": x[:2].clone(),
                         "amax": x.abs().amax().float(),
                         "y": out[:2].clone()})
        return hook

    hooks = [m.register_forward_hook(make(n))
             for n, m in quantized_convs(model).items()]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def _span(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(name)


def serve(server: Server, traffic: Traffic, first: int, until,
          trace: bool = False, captures=frozenset(),
          profile_at: Optional[range] = None, int8_rows: bool = False):
    """Issue batches from `first` while until(k, now) is false, two in
    flight: batch k+1 is issued before batch k's poses are fetched.
    Returns per-batch records, the captured stages and the profile."""
    cuda = server.dev.type == "cuda"
    recs: List[dict] = []
    caps: List[dict] = []
    pending = None
    prof = None
    k = first

    def fetch(p):
        kk, t0, out, rec = p
        with _span("bench.fetch", trace):
            R, t, ok = out[0].cpu(), out[1].cpu(), out[2].cpu()
        rec["t_done"] = time.perf_counter()
        rec["latency_s"] = rec["t_done"] - t0
        rec["solved"] = int(ok.sum())
        if "cap" in rec:
            c = rec.pop("cap")
            c.update(R=out[0], t=out[1], success=out[2],
                     n_inliers=out[3], codes=out[4])
            caps.append(c)
        recs.append(rec)

    while not until(k, time.perf_counter()):
        if profile_at is not None and cuda:
            if k == profile_at.start:
                prof = harness.ProfiledSpan()
            elif k == profile_at.stop and prof is not None:
                prof.stop()
        with _span("bench.inputs", trace):
            feed, fb, draws = traffic.batch(k)
        rec = {"k": k}
        kept = contextlib.ExitStack()
        if k in captures:
            cap = {"rgb": feed["rgb"], "roi_param": feed["roi_param"],
                   "final_bbox": fb, "K": traffic.K, "valid": feed["valid"],
                   "prio": draws.prio, "u": draws.u}
            server.rec["capture"] = cap
            kept.enter_context(hypotheses_kept(cap))
            if int8_rows and server.int8:
                int8_rows = False
                cap["int8_rows"] = []
                kept.enter_context(int8_rows_kept(server.model,
                                                  cap["int8_rows"]))
            rec["cap"] = cap
        if trace and cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            server.rec["fwd"] = (ev[1], ev[2])
            ev[0].record()
        t0 = time.perf_counter()
        with kept, _span("bench.step", trace):
            out = server.step(feed, fb, traffic.K, draws=draws)
        rec["host_issue_s"] = time.perf_counter() - t0
        if trace and cuda:
            ev[3].record()
            rec["events"] = ev
        server.rec.clear()
        if pending is not None:
            fetch(pending)
        pending = (k, t0, out, rec)
        k += 1
    if pending is not None:
        fetch(pending)
    trace_rec = None
    if prof is not None:
        if prof.running:
            prof.stop()
        trace_rec = prof.result
        trace_rec["batches"] = len(profile_at)
    return recs, caps, trace_rec


def captured_batches(tr: dict, seed: int, first: int) -> set:
    """The window's batches whose stages are compared, drawn from the
    seed."""
    rng = np.random.default_rng(seed_words(seed, 4))
    lo = first + int(tr["capture_from"])
    return set(int(x) for x in rng.choice(
        np.arange(lo, lo + int(tr["capture_span"])),
        size=int(tr["capture"]), replace=False))


def reference_side(cfg: dict, device) -> checks.ServeReference:
    """The reference: its network from its own reading of the checkpoint
    (float32, or the int8 arithmetic for an int8 configuration) and its
    own reading of the LUT."""
    from benchmark.reference.io import checkpoint_state_dict, load_lut

    m = harness.reference_network(cfg, quant=bool(cfg.get("int8", False)))
    m.load_state_dict(checkpoint_state_dict(
        str(harness.ROOT / cfg["checkpoint"])), strict=True)
    pts, valid = load_lut(str(harness.ROOT / cfg["lut"]))
    return checks.ServeReference(cfg, m.eval().to(device),
                                 torch.from_numpy(pts),
                                 torch.from_numpy(valid), device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        process_start: float):
    tr, cfg = cell.traffic, cell.config
    cuda = device.type == "cuda"
    server = Server(cfg, device)
    traffic = Traffic(cfg, tr, seed, device)
    warm = int(tr["warmup_batches"])
    serve(server, traffic, 0, lambda k, t: k >= warm)
    if cuda:
        torch.cuda.synchronize()
    captures = captured_batches(tr, seed, warm)
    profile_at = None
    if trace:
        p0 = warm + int(tr["profile_from"])
        profile_at = range(p0, p0 + int(tr["profile_batches"]))
    # the window: batches issued until the time is up (and at least up
    # to every captured and profiled one), all fetched
    last = max(captures | ({profile_at.stop} if profile_at else set()))
    setup_s = time.time() - process_start
    t_start = time.perf_counter()
    end = t_start + seconds
    recs, caps, prof = serve(
        server, traffic, warm, lambda k, t: t >= end and k > last, trace,
        captures, profile_at, int8_rows=True)
    window_s = recs[-1]["t_done"] - t_start
    mem_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    crops = len(recs) * traffic.B
    result = {"attempted": crops, "failed": 0, "metrics": {},
              "device": device_record(cell, device, mem_peak)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end()
             + cell.per_layer()}
    if trace:
        run_rec = {"config": cfg, "traffic": tr, "batch": traffic.B,
                   "host_issue_s": [r["host_issue_s"] for r in recs],
                   "profile": prof,
                   "conv_layers": flops.conv_layers(cfg, traffic.B)}
        if cuda:
            run_rec["forward_ms"] = [r["events"][1].elapsed_time(
                r["events"][2]) for r in recs]
            run_rec["decode_ms"] = [r["events"][2].elapsed_time(
                r["events"][3]) for r in recs]
        result["metrics"] = per_layer(cell, run_rec)
        if prof is not None:
            result["device"].update(busy_s=prof["busy_s"],
                                    window_s=prof["window_s"])
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
    else:
        lat = [r["latency_s"] * 1e3 for r in recs]
        vals = {"crops_per_s": crops / window_s,
                "batch_p95_ms": harness.percentile(lat, 95),
                "setup_s": setup_s}
        result["metrics"] = {k: {"value": v, "unit": units[k]}
                             for k, v in vals.items() if k in units}
    result["solved_share"] = sum(r["solved"] for r in recs) / crops
    # the program's state goes before the reference runs
    del server
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_side(cfg, device)
    numbers = checks.worst([checks.serve_numbers(ref, c) for c in caps])
    judged = checks.judge(numbers, cfg["limits"]["serve"])
    result["correct"] = checks.passed(judged) and len(caps) == len(captures)
    return result, judged


def per_layer(cell, run_rec) -> Dict[str, dict]:
    """Each per-layer metric of the cell, read by its own file; a reader
    that finds nothing leaves its metric out."""
    out = {}
    for m in cell.per_layer():
        v = cell.reader(m["name"]).read(run_rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def device_record(cell, device, mem_peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    kind, limit = harness.card_identity()
    return {"platform": "gpu", "kind": kind, "count": cell.chips,
            "memory_peak_bytes": int(mem_peak), "power_limit": limit}
