"""What decides `correct`: the numbers that compare what a timed path
produced with the plain reference (`reference/`), each beside a limit
from its configuration file.

Serving follows the program stage by stage from its own outputs, since
RANSAC's choice of a hypothesis swings on ties of inlier counts that
rounding decides: each stage's input is what the program's previous
stage produced, and each number compares one stage.

  crop_err           max |crop - reference crop| over the batch
  logit_rel          ||logits - reference||_2 / ||reference||_2, the
                     reference forward run on the program's crop;
  logit_rel_<head>   the same of one head (mask, entire_mask, code)
  code_mismatch      code bits that differ from the reference's binarize
                     of the program's logits (exact)
  sample_mismatch    minimal-set coordinates that differ from the
                     reference's correspondences, subset and draws
                     (exact)
  mask_flip_far      the share of visible-mask pixels whose foreground
                     decision differs from the reference's, where the
                     reference's logit lies beyond MASK_GATE of its RMS
                     from 0 (near 0, rounding decides either way)
  hyp_rot_err_ratio, the median, over the B x H minimal sets, of the
  hyp_trans_err_ratio gap between the program's hypotheses and the
                     reference EPnP's in float64 on the same sets, over
                     the same median of the reference's float32 EPnP
  hyp_rot_far_excess, the share of minimal sets whose hypothesis lies
  hyp_trans_far_excess farther than HYP_FAR from the float64 solve, less
                     the reference float32's share on the same sets: a
                     fault in a minority of the solves moves it where
                     the median hardly moves
  final_mismatch     success flags and inlier counts that differ from
                     the reference's scoring, refit and polish of the
                     program's hypotheses (exact)
  final_rot_max_deg, the widest gap of the final poses over the batch
  final_trans_max_mm
  int8_mismatch      outputs of the quantized convs (two rows of each)
                     that differ from the integer arithmetic (exact)

Training follows its first steps (`train_numbers`)."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from benchmark import harness
from benchmark.reference import binarize as ref_binarize
from benchmark.reference import crop as ref_crop
from benchmark.reference import pnp as ref_pnp
from benchmark.reference.int8 import div127, int8_conv2d
from benchmark.reference.layers import quantize_weight


@contextlib.contextmanager
def precision(tf32: bool):
    """The reference's float32 (TF32 off), or TF32 (the control of a
    float32 stage), for matmuls and cuDNN; restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every limited number; a number the
    run could not read is NaN and fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        out[name] = {"value": float(v), "limit": float(limit)}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def rotation_gap_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The rotation angle between Ra and Rb in degrees, from the
    Frobenius distance (||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2) for two
    rotations), so two equal matrices read 0 even where a degenerate
    solve gave no rotation; 0 where both are non-finite, inf where one
    is."""
    d = torch.linalg.matrix_norm(Ra - Rb)
    ang = torch.rad2deg(2 * torch.arcsin(torch.clamp(
        d / (2 * 2 ** 0.5), 0.0, 1.0)))
    fa = torch.isfinite(Ra).all(-1).all(-1)
    fb = torch.isfinite(Rb).all(-1).all(-1)
    return torch.where(fa & fb, ang, torch.where(fa | fb, torch.inf, 0.0))


def translation_gap(ta: torch.Tensor, tb: torch.Tensor) -> torch.Tensor:
    d = torch.linalg.vector_norm(ta - tb, dim=-1)
    fa, fb = torch.isfinite(ta).all(-1), torch.isfinite(tb).all(-1)
    return torch.where(fa & fb, d, torch.where(fa | fb, torch.inf, 0.0))


def _quant(x: torch.Tensor, q: float) -> float:
    x = x.double().flatten()
    if x.numel() == 0:
        return float("nan")
    k = max(int(round(q * (x.numel() - 1))), 0)
    return float(torch.sort(x).values[k])


def _ratio(a: float, b: float) -> float:
    """a / b; 1 where both are 0 (both exact), inf where only b is."""
    if b == 0:
        return 1.0 if a == 0 else float("inf")
    return a / b


def _rel(cand: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((cand - ref).double())
                 / torch.linalg.vector_norm(ref.double()))


def _logits(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([out[k].float().flatten(1)
                      for k in ("mask", "entire_mask", "code") if k in out],
                     1)


# a visible-mask pixel counts as flipped only where the reference's
# logit lies beyond this share of its root mean square logit from 0
MASK_GATE = 0.01


def mask_flip_share(mask: torch.Tensor, ref: torch.Tensor,
                    gate: float) -> float:
    """The share of visible-mask pixels on the other side of the
    foreground decision (logit 0) from the reference, among those whose
    reference logit is farther than `gate` x its RMS from 0."""
    m, r = mask.float().flatten(), ref.float().flatten()
    far = r.abs() > gate * torch.sqrt(torch.mean(r * r))
    return float(((m > 0) != (r > 0))[far].sum()) / r.numel()


# a hypothesis this far from the float64 solve of its minimal set counts
# as astray (degrees, millimetres): beyond the ~0.35 deg and ~1.5 mm
# median by which float32 strays on these ill-conditioned sets
HYP_FAR = {"rot": 1.0, "trans": 10.0}


class ServeReference:
    """The reference's side of a serving cell: its network (float32, or
    the int8 arithmetic with `qmax`), the LUT and the decode's
    settings, on `device`."""

    def __init__(self, config: dict, model: torch.nn.Module,
                 lut_points: torch.Tensor, lut_valid: torch.Tensor,
                 device):
        s = config["shapes"]
        self.crop_img, self.crop_gt = s["crop_img"], s["crop_gt"]
        self.resize = s["resize_method"]
        self.base = config["network"]["base"]
        self.n_bits = config["network"]["code_bits"]
        self.loss_type = config["network"]["loss_type"]
        self.cfg = ref_pnp.PnPConfig(**config["pnp"])
        self.model, self.device = model, device
        self.lut = (lut_points.to(device), lut_valid.to(device))

    def crop(self, cap) -> torch.Tensor:
        raw = {"rgb": cap["rgb"].to(self.device),
               "roi_param": torch.as_tensor(cap["roi_param"],
                                            device=self.device),
               "valid": torch.as_tensor(cap["valid"], device=self.device)}
        return ref_crop.preprocess_batch(
            raw, crop_img=self.crop_img, crop_gt=self.crop_gt,
            base=self.base, n_bits=self.n_bits, resize_method=self.resize,
            include_gt=False)["image"]

    @torch.no_grad()
    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        with precision(False):
            return self.model(image.to(self.device, torch.float32))

    def prepare(self, cap):
        """Correspondences, subset and minimal sets of the program's
        logits under the batch's draws."""
        out = cap["logits"]
        valid = torch.as_tensor(cap["valid"], device=self.device)
        masks = ref_binarize.mask_from_logits(
            out["mask"].float()[..., 0]) * valid[:, None, None]
        codes = ref_binarize.code_from_logits(out["code"].float(),
                                              self.loss_type, base=self.base)
        pts3d, orig, fg = ref_pnp._correspondences(
            masks, codes, *self.lut,
            torch.as_tensor(cap["final_bbox"], device=self.device),
            self.crop_gt, self.base)
        prep = ref_pnp._ransac_prepare(pts3d, orig, fg, self.cfg,
                                       cap["prio"], cap["u"])
        return codes, prep

    def hypotheses(self, cap, dtype: torch.dtype = torch.float32):
        """The plain minimal-set EPnP on the program's minimal sets, in
        `dtype` (float32 results)."""
        saved = torch.get_default_dtype()
        with precision(False):
            # scalars the solver makes follow its dtype
            torch.set_default_dtype(dtype)
            try:
                R, t = ref_pnp.minimal_epnp_hypotheses(
                    cap["samp3d"].to(dtype), cap["samp2d"].to(dtype),
                    cap["Ks"].to(dtype), self.cfg.gn_iters)
            finally:
                torch.set_default_dtype(saved)
        return R.float(), t.float()

    def finish(self, prep, cap, tf32: bool = False):
        sub3d, sub2d, sub_w, _, _, n_fg = prep
        B = sub_w.shape[0]
        H = self.cfg.n_hypotheses
        K = torch.as_tensor(cap["K"], device=self.device,
                            dtype=torch.float32)
        with precision(tf32):
            return ref_pnp._ransac_finish(
                sub3d, sub2d, sub_w, cap["Rs"].reshape(B, H, 3, 3),
                cap["ts"].reshape(B, H, 3), K, n_fg, self.cfg)


@torch.no_grad()
def serve_numbers(ref: ServeReference, cap: dict,
                  control: Optional[dict] = None) -> Dict[str, float]:
    """The compared numbers of one captured batch. `control` replaces
    the program's outputs stage by stage with the control's ("crop",
    "logits", "hyp_dtype", "tf32"), to read the numbers the control
    gives."""
    control = control or {}
    num: Dict[str, float] = {}
    crop_ref = ref.crop(cap)
    crop = control.get("crop", cap["crop"])
    num["crop_err"] = float((crop.float() - crop_ref).abs().max())
    logits_ref = ref.forward(cap["crop"])
    logits = control.get("logits", cap["logits"])
    num["logit_rel"] = _rel(_logits(logits), _logits(logits_ref))
    for head in ("mask", "entire_mask", "code"):
        if head in logits:
            num[f"logit_rel_{head}"] = _rel(logits[head].float(),
                                            logits_ref[head].float())
    num["mask_flip_far"] = mask_flip_share(logits["mask"],
                                           logits_ref["mask"], MASK_GATE)
    del logits_ref
    codes, prep = ref.prepare(cap)
    num["code_mismatch"] = float((codes != cap["codes"]).sum())
    samp3d, samp2d = prep[3], prep[4]
    num["sample_mismatch"] = float(
        (samp3d.reshape(cap["samp3d"].shape) != cap["samp3d"]).sum()
        + (samp2d.reshape(cap["samp2d"].shape) != cap["samp2d"]).sum())
    tf32 = bool(control.get("tf32", False))
    # minimal sets are ill-conditioned: float32 itself strays from the
    # float64 solution, so each side's error against float64 is measured
    # and the program's median is held to the reference's float32 one
    R64, t64 = ref.hypotheses(cap, dtype=torch.float64)
    Rh, th = ref.hypotheses(cap)
    if "hyp_dtype" in control:
        cand = ref.hypotheses(cap, dtype=control["hyp_dtype"])
    else:
        cand = (cap["Rs"], cap["ts"])
    gaps = {"rot": (rotation_gap_deg(cand[0], R64),
                    rotation_gap_deg(Rh, R64)),
            "trans": (translation_gap(cand[1], t64),
                      translation_gap(th, t64))}
    for kind, (prog, ref32) in gaps.items():
        num[f"hyp_{kind}_err_ratio"] = _ratio(_quant(prog, 0.5),
                                              _quant(ref32, 0.5))
        far = HYP_FAR[kind]
        num[f"hyp_{kind}_far_excess"] = float(
            (prog > far).double().mean() - (ref32 > far).double().mean())
    R, t, ok, n_in = ref.finish(prep, cap)
    if tf32:
        cR, ct, cok, cn = ref.finish(prep, cap, tf32=True)
    else:
        cR, ct, cok, cn = (cap["R"], cap["t"], cap["success"],
                           cap["n_inliers"])
    num["final_mismatch"] = float((cok != ok).sum() + (cn != n_in).sum())
    num["final_rot_max_deg"] = float(rotation_gap_deg(cR, R).max())
    num["final_trans_max_mm"] = float(translation_gap(ct, t).max())
    if "int8_rows" in cap and "logits" not in control:
        num["int8_mismatch"] = int8_mismatch(cap["int8_rows"],
                                             ref.model, ref.device)
    return num


@torch.no_grad()
def int8_mismatch(rows: List[dict], ref_model: torch.nn.Module,
                  device) -> float:
    """Output elements of the quantized convs' captured rows that differ
    from the integer arithmetic on the same inputs: the activation scale
    from the whole input's absmax, the weights quantized by the
    reference from its own copy of the checkpoint, the sums exact in
    float64, the epilogue in float32, the program's output dtype."""
    mods = dict(ref_model.named_modules())
    bad = 0
    for r in rows:
        m = mods[r["name"]]
        x = r["x"].to(device)
        sx = div127(torch.clamp_min(r["amax"].to(device).float(), 1e-8))
        xq = torch.clamp(torch.round(x.float() / sx), -127, 127)
        wq, sw = quantize_weight(m.weight.to(device))
        y = int8_conv2d(xq.permute(0, 2, 3, 1), wq.permute(0, 2, 3, 1),
                        sx.reshape(1), sw,
                        None if m.bias is None else m.bias.to(device),
                        m.stride[0], m.padding[0], m.dilation[0],
                        r["y"].dtype, exact=True).permute(0, 3, 1, 2)
        bad += int((y != r["y"].to(device)).sum())
    return float(bad)


def worst(per_batch: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst reading over the captured batches."""
    out: Dict[str, float] = {}
    for nums in per_batch:
        for k, v in nums.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out



def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep, q: float = 1.0) -> float:
    """The leaves' gaps of norms, |‖prog‖ - ‖ref‖| over the larger of
    ‖ref‖ and the median leaf's ‖ref‖: the worst (q = 1) or the q-th
    quantile over the leaves."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in keep}
    med = float(torch.tensor(sorted(norms.values())).median())
    gaps = sorted(
        abs(float(torch.linalg.vector_norm(prog[k].double())) - norms[k])
        / max(norms[k], med) for k in keep)
    return gaps[min(int(round(q * (len(gaps) - 1))), len(gaps) - 1)]


def reference_steps(cfg: dict, tr: dict, seed: int, split, init: dict,
                    n: int, device, fp8: bool = False) -> dict:
    """The reference's first n steps from the weights `init` on the
    split, with the iterator's draws worked out again and each step's
    augmentation drawn from a generator seeded as the program's is
    (float32, TF32 off; `fp8`: every conv on fp8 operands, the training
    control). Returns what a program's snapshot holds (`Trainer.
    checked_steps`): each step's draws, batch and loss, the first
    step's logits, Adam's first moments after step 1, and after step n
    the parameters, BN statistics and histogram; and the first gradient
    itself."""
    from benchmark.drivers.serve import torch_seed
    from benchmark.reference import losses as ref_losses
    from benchmark.reference.adam import Adam
    from benchmark.reference.fp8 import fp8_convs
    from benchmark.reference.train_draws import BatchDraws

    net, s, t = cfg["network"], cfg["shapes"], cfg["train"]
    B = int(tr["batch"])
    draws = BatchDraws(split.bboxes, B, torch_seed(seed, 23),
                       torch_seed(seed, 22), s["padding_ratio"])
    model = harness.reference_network(cfg)
    model.load_state_dict(init)
    model = model.to(device).train()
    if fp8:
        fp8_convs(model)
    params = dict(model.named_parameters())
    adam = Adam(params, t["learning_rate"])
    hist = ref_losses.fresh_histogram(net["code_bits"], device)
    loss_cfg = ref_losses.CodeLossConfig(
        loss_type=net["loss_type"], mask_code_loss=t["mask_binary_code_loss"],
        use_histogram_weighting=t["use_histogram_weighted_binary_loss"],
        base=net["base"], n_bits=net["code_bits"])
    pre = dict(crop_img=s["crop_img"], crop_gt=s["crop_gt"],
               base=net["base"], n_bits=net["code_bits"],
               resize_method=s["resize_method"],
               use_pepper_salt=t["use_pepper_salt"],
               use_motion_blur=t["use_motion_blur"])
    out: Dict = {"raw": [], "batches": [], "loss": []}
    with precision(False):
        for i in range(n):
            idx, roi, valid = draws.next()
            out["raw"].append({"idx": idx, "roi_param": roi})
            g = torch.Generator(device=device).manual_seed(
                torch_seed(seed, 24, i))
            batch = ref_crop.gather_preprocess_batch(
                split.arrays, torch.as_tensor(idx), torch.as_tensor(roi),
                torch.as_tensor(valid), generator=g, **pre)
            out["batches"].append(batch)
            model.zero_grad(set_to_none=True)
            pred = model(batch["image"])
            loss, hist, _ = ref_losses.total_loss(
                pred, batch["mask"],
                batch["entire_mask"] if t["predict_entire_mask"] else None,
                batch["code"], hist, loss_cfg, t["binary_loss_weight"])
            loss.backward()
            grads = {k: p.grad.detach() for k, p in params.items()
                     if p.grad is not None}
            adam.step(grads)
            if i == 0:
                out["logits_1"] = {k: v.detach() for k, v in pred.items()}
                out["g1"] = {k: v.clone() for k, v in grads.items()}
                out["m1"] = {k: adam.m[k].clone() for k in grads}
            out["loss"].append(float(loss.detach()))
    out["params"] = {k: p.detach().clone() for k, p in params.items()}
    out["buffers"] = {k: b.clone() for k, b in model.named_buffers()
                      if "running" in k}
    out["histogram"] = hist
    out["b1"] = adam.b1
    return out


def train_numbers(cfg: dict, tr: dict, seed: int, split, init: dict,
                  snap: dict, device) -> Dict[str, float]:
    """The reference follows the program's first steps from the same
    weights, frames and draws (`reference_steps`) and compares:

      input_mismatch  frame indices and crop params that differ from the
                      reference's own working of the iterator's draws
                      (exact)
      batch_err       max |batch - reference batch| (crop, augment,
                      masks, code planes)
      loss_gap_1      the relative gap of the first step's total loss
      loss_gap        the widest of the steps' relative loss gaps
      logit_rel_1     ||logits - reference||_2 / ||reference||_2 of the
                      first step's forward (all three heads)
      grad_gap        the worst leaf's gap of first-gradient norms (the
                      program's from Adam's first moment after step 1);
                      grad_gap_median_leaf the median leaf's
      update_gap      the worst leaf's gap of the norms of the
                      parameters' change after the steps;
                      update_gap_median_leaf the median leaf's
      bn_gap          the worst BN statistic's distance after the steps,
                      over its norm (or the median's); bn_gap_median the
                      median statistic's
      hist_gap        the widest gap of the bit-error histogram after
                      the steps

    Leaves whose reference gradient is below a thousandth of the median
    leaf's (a bias under a following BatchNorm, a head the loss leaves
    out) move by round-off alone and are left out of grad_gap and
    update_gap."""
    n = len(snap["loss"])
    ref = reference_steps(cfg, tr, seed, split, init, n, device)
    num = {"input_mismatch": 0.0, "batch_err": 0.0, "loss_gap": 0.0}
    for i in range(n):
        r, raw = ref["raw"][i], snap["raw"][i]
        num["input_mismatch"] += float(
            (torch.as_tensor(r["idx"]) != torch.as_tensor(raw["idx"]).cpu()
             ).sum()
            + (torch.as_tensor(r["roi_param"])
               != torch.as_tensor(raw["roi_param"]).cpu()).sum())
        rb, pb = ref["batches"][i], snap["batches"][i]
        num["batch_err"] = max(num["batch_err"], max(
            float((rb[k].float() - pb[k].float()).abs().max())
            if rb[k].shape == pb[k].shape else float("inf") for k in rb))
        lr = ref["loss"][i]
        num["loss_gap"] = max(num["loss_gap"],
                              abs(snap["loss"][i] - lr) / abs(lr))
    num["loss_gap_1"] = abs(snap["loss"][0] - ref["loss"][0]) / abs(
        ref["loss"][0])
    a, b = _logits(snap["logits_1"]), _logits(ref["logits_1"])
    num["logit_rel_1"] = _rel(a, b) if a.shape == b.shape else float("inf")
    g1 = ref["g1"]
    gnorm = {k: float(torch.linalg.vector_norm(v)) for k, v in g1.items()}
    med = float(torch.tensor(sorted(gnorm.values())).median())
    keep = [k for k, v in gnorm.items() if v >= 1e-3 * med]
    num["leaves_compared"] = float(len(keep))
    # a leaf the program never moved has no first moment: its gradient
    # as the optimizer got it reads 0
    prog_g1 = {k: snap["m1"][k] / (1.0 - ref["b1"]) if k in snap["m1"]
               else torch.zeros_like(g1[k]) for k in keep}
    num["grad_gap"] = _leaf_gap(prog_g1, g1, keep)
    num["grad_gap_median_leaf"] = _leaf_gap(prog_g1, g1, keep, q=0.5)
    d_prog = {k: snap["params"][k] - init[k] for k in keep}
    d_ref = {k: ref["params"][k] - init[k] for k in keep}
    num["update_gap"] = _leaf_gap(d_prog, d_ref, keep)
    num["update_gap_median_leaf"] = _leaf_gap(d_prog, d_ref, keep, q=0.5)
    bufs = ref["buffers"]
    bnorm = {k: float(torch.linalg.vector_norm(bufs[k].double()))
             for k in snap["buffers"]}
    bmed = float(torch.tensor(sorted(bnorm.values())).median())
    bgaps = sorted(
        float(torch.linalg.vector_norm((snap["buffers"][k] - bufs[k])
                                       .double())) / max(bnorm[k], bmed)
        for k in snap["buffers"])
    num["bn_gap"] = bgaps[-1]
    num["bn_gap_median"] = bgaps[len(bgaps) // 2]
    num["hist_gap"] = float((snap["histogram"] - ref["histogram"])
                            .abs().max())
    return num
