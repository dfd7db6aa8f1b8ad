"""Per-object fleet training: K objects' models in one program.

Port of `zebrapose_tpu/train/fleet.py`. ZebraPose trains one network per
object, and the reference runs one process per object. Here the K
members' parameters, gradients, BN statistics, Adam moments and
bit-error histograms live in stacks with a leading member axis
(`FleetState`), and one function advances every member
(`fleet_train_step`): each member's forward and backward in turn, on a
module whose parameters, gradients and buffers are views of its slice of
the stacks, then one Adam step over the stacked tensors.

JAX vmaps one member's step over the stacks. A vmapped step
(`torch.func.functional_call` and `grad_and_value` under
`torch.func.vmap`) ran 3.1x two single steps on the H100, with 10.8x
their memory (PERF.md §6): under vmap CUDA's batch_norm cannot ask a
tensor for its memory format, so BatchNorm had to run as float32
tensor ops on NCHW activations, and the K convolutions became grouped
NCHW ones. Members in turn keep each step the single-object step (cuDNN
channels-last, fused BatchNorm), share the optimizer's launches, and
hold the fleet in one state.

Semantics per member are the single-object recipe's: BatchNorm batches,
the histogram EMA, the Adam schedule and best-checkpoint selection are
per member. The fleet's evaluation (`eval/fleet_serve.py`) does vmap
one forward over the stacked weights.

Across a world of W ranks (`parallel/mesh.py`, one process a card under
torchrun), the counterpart of JAX's model-axis mesh: the fleet is padded
to Kp, the next multiple of W, with ghost rows (copies of the last
member, `stack_states(pad_to=)`) and rank r builds and owns rows
[r·Kp/W, (r+1)·Kp/W) (`member_rows`), as P("model") shards the padded
axis. `fleet_train_step` needs no collective, as JAX's `shard_map` has
none; each member's checkpoints and logs come from the rank that owns
it, ghost rows are never saved or reported, and `fit_fleet` returns the
K real members' bests on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from zebrapose_tpu_torch.models.losses import CodeLossConfig, total_loss
from zebrapose_tpu_torch.parallel.mesh import (
    World,
    all_gather_object,
    make_mesh,
)
from zebrapose_tpu_torch.train.state import TrainState

def stack_tensors(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """[K, ...] stack of equal-shape tensors. A stack of 4-D convolution
    weights keeps each member's slice channels-last, the layout the
    single-object model runs with."""
    x0 = xs[0]
    if x0.dim() != 4:
        return torch.stack([x.detach() for x in xs])
    o, i, h, w = x0.shape
    out = torch.empty((len(xs), o, h, w, i), dtype=x0.dtype,
                      device=x0.device).permute(0, 1, 4, 2, 3)
    for k, x in enumerate(xs):
        out[k].copy_(x.detach())
    return out


@dataclasses.dataclass
class FleetState:
    """K members' training state, stacked.

    members: member k's module; its parameters and buffers are views of
           slice k of `params` and `buffers`.
    params / buffers: [K, ...] by parameter / buffer name; the params
           are the leaves `optimizer` (Adam) updates from their stacked
           `.grad`.
    template: the architecture on the meta device, for functional_call
           in the vmapped evaluation (`eval/fleet_serve.py`; it leaves
           its template's tensors swapped, so `blank` is kept apart).
    blank: the architecture on the meta device, never run; `index_state`
           copies it.
    histogram: [K, n_bits] bit-error EMAs; best_score: one a member.
    step: the members' common step."""
    members: List[torch.nn.Module]
    params: Dict[str, torch.Tensor]
    buffers: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    histogram: torch.Tensor
    best_score: List[float]
    template: torch.nn.Module
    blank: torch.nn.Module
    step: int = 0


def _owner(model: torch.nn.Module, name: str):
    path, _, leaf = name.rpartition(".")
    return model.get_submodule(path), leaf


def stack_states(states: Sequence[TrainState],
                 pad_to: Optional[int] = None) -> FleetState:
    """Stack K members' TrainStates (one architecture, Adam) into one
    FleetState with their Adam moments; each member's module is rebound
    to views of its slice (its own tensors are dropped). A resume needs
    a common step: members restored at different steps are refused, as
    in JAX.

    `pad_to`: pad the member axis to this length with ghost rows, copies
    of the last state (weights, BN statistics, Adam's moments, the
    histogram and the best score) each with a module and tensors of its
    own, since every member's module is rebound to views of its slice.
    Ghost rows train on the last member's batches and are never saved or
    reported (`FleetResources.n_pad`)."""
    if pad_to is not None and pad_to > len(states):
        states = list(states) + [copy.deepcopy(states[-1])
                                 for _ in range(pad_to - len(states))]
    steps = sorted({int(s.step) for s in states})
    if len(steps) > 1:
        raise ValueError(
            f"fleet members restored at different steps {steps}; resume "
            "them to a common step (or train separately)")
    s0 = states[0]
    named = [dict(s.model.named_parameters()) for s in states]
    bufs = [dict(s.model.named_buffers()) for s in states]
    params = {n: stack_tensors([p[n] for p in named]).requires_grad_()
              for n in named[0]}
    buffers = {n: stack_tensors([b[n] for b in bufs]) for n in bufs[0]}
    for p in params.values():
        p.grad = torch.zeros_like(p)
    group = s0.optimizer.param_groups[0]
    optimizer = torch.optim.Adam(
        list(params.values()), lr=s0.schedule(steps[0]),
        betas=group["betas"], eps=group["eps"],
        weight_decay=group["weight_decay"])
    # Adam is elementwise: on the stacked [K, ...] tensors, with one lr
    # and one step count, it is K independent Adams of the members
    for n, p in params.items():
        moments = [s.optimizer.state.get(q[n], {})
                   for s, q in zip(states, named)]
        if moments[0]:
            optimizer.state[p] = {
                "step": moments[0]["step"].clone(),
                "exp_avg": stack_tensors([m["exp_avg"] for m in moments]),
                "exp_avg_sq": stack_tensors([m["exp_avg_sq"]
                                             for m in moments])}
    template = copy.deepcopy(s0.model).to("meta")
    blank = copy.deepcopy(template)
    for k, s in enumerate(states):
        for n, p in params.items():
            owner, leaf = _owner(s.model, n)
            owner._parameters[leaf] = torch.nn.Parameter(p.detach()[k])
        for n, b in buffers.items():
            owner, leaf = _owner(s.model, n)
            owner._buffers[leaf] = b[k]
    return FleetState(
        members=[s.model for s in states], params=params, buffers=buffers,
        optimizer=optimizer, schedule=s0.schedule,
        histogram=torch.stack([s.histogram for s in states]),
        best_score=[float(s.best_score) for s in states],
        template=template, blank=blank, step=steps[0])


def index_state(fleet: FleetState, i: int) -> TrainState:
    """Member i's state as a single-object TrainState (a module of its
    own holding its weights and BN statistics, with its Adam moments,
    histogram and best score), for its checkpoints."""
    dev = fleet.histogram.device
    model = copy.deepcopy(fleet.blank).to_empty(device=dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(fleet.params[n][i])
        for n, b in model.named_buffers():
            b.copy_(fleet.buffers[n][i])
    group = fleet.optimizer.param_groups[0]
    optimizer = torch.optim.Adam(model.parameters(), lr=group["lr"],
                                 betas=group["betas"], eps=group["eps"],
                                 weight_decay=group["weight_decay"])
    for n, p in model.named_parameters():
        st = fleet.optimizer.state.get(fleet.params[n])
        if st:
            optimizer.state[p] = {"step": st["step"].clone(),
                                  "exp_avg": st["exp_avg"][i].clone(),
                                  "exp_avg_sq": st["exp_avg_sq"][i].clone()}
    return TrainState(model=model, optimizer=optimizer,
                      schedule=fleet.schedule, step=fleet.step,
                      histogram=fleet.histogram[i].clone(),
                      best_score=fleet.best_score[i])


def fleet_train_step(state: FleetState, batch: Dict[str, torch.Tensor],
                     loss_cfg: CodeLossConfig,
                     binary_loss_weight: float = 3.0,
                     predict_entire_mask: bool = True, bf16: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """One optimizer step of every member, in place.

    `batch` leaves are flat [K·B, ...] in object-major order (member k
    owns rows [k·B, (k+1)·B)), as `preprocess_batch` makes them. Each
    member's forward and backward runs in turn on its module (the
    gradients land in its slice of the stacked gradients), then one Adam
    step updates the stacks. Returns per-member metrics, each [K]:
    total_loss's and `grad_norm` (the float32 norm of each member's
    gradient)."""
    k = len(state.members)
    bt = {n: v.reshape((k, -1) + v.shape[1:]) for n, v in batch.items()}
    hists, metrics = [], []
    for i, model in enumerate(state.members):
        model.train()
        with torch.autocast(bt["image"].device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            out = model(bt["image"][i])
        gt_entire = bt["entire_mask"][i] if predict_entire_mask and \
            "entire_mask" in bt else None
        loss, hist, m = total_loss(out, bt["mask"][i], gt_entire,
                                   bt["code"][i], state.histogram[i],
                                   loss_cfg, binary_loss_weight)
        loss.backward()
        # the member's gradients into its slice of the stacked ones, and
        # their norm as apply_accumulated takes it
        grads = [p.grad for p in model.parameters()]
        torch._foreach_copy_([p.grad[i] for p in state.params.values()],
                             grads)
        m["grad_norm"] = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)).float())
        model.zero_grad(set_to_none=True)
        hists.append(hist)
        metrics.append({n: v.detach() for n, v in m.items()})
    out = {n: torch.stack([m[n] for m in metrics]) for n in metrics[0]}
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.histogram = torch.stack(hists)
    state.step += 1
    return out


def member_rows(k: int, world: World) -> range:
    """The rows of a K-member fleet that `world`'s rank owns: the fleet
    padded to Kp, the next multiple of W, rank r owning [r·Kp/W,
    (r+1)·Kp/W); rows from K on are ghost rows."""
    per = -(-k // world.size)
    return range(world.rank * per, (world.rank + 1) * per)


@dataclasses.dataclass
class FleetResources:
    """K single-object TrainResources driven by one fleet program.
    Members share every shape-deciding setting (crop sizes, code,
    architecture, batch size); datasets, LUTs, checkpoints and logs are
    per member.

    In a world of W ranks: `members` are the real members this rank
    owns, `state` holds its rows (those members, then its ghost rows),
    `first` is the fleet index of its first row and `n_pad` the ghost
    rows of the whole fleet (Kp - K). A ghost row trains on the batches
    of member K-1; `ghost_source` is member K-1's data on a rank that
    holds ghost rows without it (no checkpoints, no logs)."""
    members: list  # List[TrainResources]
    state: FleetState
    n_pad: int = 0
    world: World = World()
    first: int = 0
    ghost_source: Optional[object] = None  # TrainResources

    @property
    def rows(self) -> list:
        """The TrainResources of each of this rank's rows: a ghost row's
        are member K-1's."""
        src = self.ghost_source or self.members[-1]
        return self.members + [src] * (len(self.state.members)
                                       - len(self.members))


def build_fleet_setup(cfg, obj_names: Sequence[str], output_dir: str,
                      world: Optional[World] = None,
                      **member_kwargs) -> FleetResources:
    """A fleet from one config and K object names: each member built by
    `build_train_setup` on a world of one (no world scaling of lr or
    iterations: each object trains at the single-GPU recipe) under
    `<output_dir>/<obj_name>/`, then their states stacked. `world`
    (default `parallel.mesh.make_mesh(device)`: the torchrun world when
    there is one) spreads the members over its ranks (`member_rows`):
    this rank builds only the members it owns, and its ghost rows copy
    member K-1. Ranks restored at different steps are refused."""
    from zebrapose_tpu_torch.train.trainer import build_train_setup

    device = member_kwargs.pop("device", None)
    if world is None:
        world = make_mesh(device)
    one = World(device=world.device)
    k = len(obj_names)
    rows = member_rows(k, world)

    def build(i, write=True):
        return build_train_setup(
            cfg, obj_names[i], os.path.join(output_dir, obj_names[i]),
            world=one, write=write, **member_kwargs)

    members = [build(i) for i in rows if i < k]
    # only ghost rows here: member K-1's data, writing nothing
    ghost_source = None if members else build(k - 1, write=False)
    shapes = {(m.cfg.BoundingBox_CropSize_image,
               m.cfg.BoundingBox_CropSize_GT, m.cfg.number_of_itration,
               m.cfg.divide_number_each_itration, m.cfg.batch_size)
              for m in members}
    if len(shapes) > 1:
        raise ValueError(f"fleet members disagree on shapes: {shapes}")
    state = stack_states([m.state for m in members or [ghost_source]],
                         pad_to=len(rows))
    steps = sorted(set(all_gather_object(state.step, world)))
    if len(steps) > 1:
        raise ValueError(
            f"fleet members restored at different steps {steps}; resume "
            "them to a common step (or train separately)")
    return FleetResources(members=members, state=state,
                          n_pad=len(rows) * world.size - k, world=world,
                          first=rows.start, ghost_source=ghost_source)


def fleet_eval_step(members, state: FleetState):
    """The fleet eval program over the members' LUTs that validates the
    stacked train state (`eval/fleet_serve.py`)."""
    from zebrapose_tpu_torch.eval.fleet_serve import (
        make_fleet_eval_step,
        model_forward,
        stack_luts,
    )

    if len({m.pnp_cfg for m in members}) > 1:
        raise ValueError("fleet members disagree on pnp_cfg")
    cfg = members[0].cfg
    lp, lv = stack_luts([m.lut for m in members])
    return make_fleet_eval_step(
        model_forward(state.template, members[0].bf16), lp, lv,
        crop_img=cfg.BoundingBox_CropSize_image,
        crop_gt=cfg.BoundingBox_CropSize_GT,
        base=cfg.divide_number_each_itration,
        n_bits=cfg.number_of_itration, resize_method=cfg.resize_method,
        loss_type=cfg.BinaryCode_Loss_Type, pnp_cfg=members[0].pnp_cfg,
        device=state.histogram.device)


def _fleet_validate(members, state: FleetState, fleet_eval, first: int = 0
                    ) -> List[Dict[str, float]]:
    """Pose validation of the whole fleet: the K val splits stream
    through the fleet eval program in lockstep with the stacked weights
    and BN statistics (eval mode, so nothing moves), and each member
    gets the single-object ADD / ADD-S metric dict. `members` are the
    rows' resources (a ghost row re-walks member K-1's split) and
    `first` the fleet index of the first: RANSAC draws follow the
    member's fleet index, not its place on this rank."""
    from zebrapose_tpu_torch.eval.evaluate import pose_errors, summarize
    from zebrapose_tpu_torch.eval.fleet_serve import fleet_infer

    dev = state.histogram.device
    # contiguous copies: the vmapped forward runs NCHW (`nchw_images`)
    variables = {n: t.detach().contiguous() for n, t in
                 {**state.params, **state.buffers}.items()}
    was_training = state.template.training
    state.template.eval()
    try:
        Rs, ts, ok = fleet_infer(
            [m.val_dataset for m in members], fleet_eval, variables,
            min(m.val_batch_size for m in members), device=dev,
            first=first)
    finally:
        state.template.train(was_training)
    out = []
    for i, m in enumerate(members):
        Rs[i][~ok[i]] = np.eye(3)
        ts[i][~ok[i]] = 0
        errors = pose_errors(m.val_dataset, Rs[i], ts[i], ok[i],
                             m.vertices, m.symmetric, device=dev)
        out.append(summarize(errors, m.diameter,
                             "ADD-S" if m.symmetric else "ADD"))
    return out


def fleet_batch(members, it: int, device,
                clock: Optional[Dict[str, float]] = None
                ) -> Dict[str, torch.Tensor]:
    """The fleet's training batch of step `it`: one batch of each
    member's iterator, object-major, preprocessed and augmented on the
    device with one generator for the K·B batch
    (`trainer.aug_generator(it)`), as JAX draws one key for the flat
    batch. A member listed again (the ghost rows of member K-1) takes
    the batch its first row took, as JAX's ghost rows re-train on the
    last member's batch. `clock["wait_s"]` adds the time spent waiting
    for batches."""
    from zebrapose_tpu_torch.data.pipeline import FEED_KEYS, preprocess_batch
    from zebrapose_tpu_torch.train.trainer import aug_generator

    cfg = members[0].cfg
    t0 = time.perf_counter()
    drawn: Dict[int, Dict[str, np.ndarray]] = {}
    for m in members:
        if id(m) not in drawn:
            drawn[id(m)] = next(m.train_iter)
    raws = [drawn[id(m)] for m in members]
    if clock is not None:
        clock["wait_s"] += time.perf_counter() - t0
    feed = {k: torch.as_tensor(np.concatenate([r[k] for r in raws]))
            .to(device) for k in FEED_KEYS}
    return preprocess_batch(
        feed, crop_img=cfg.BoundingBox_CropSize_image,
        crop_gt=cfg.BoundingBox_CropSize_GT,
        base=cfg.divide_number_each_itration,
        n_bits=cfg.number_of_itration, resize_method=cfg.resize_method,
        is_train=True, use_pepper_salt=cfg.use_peper_salt,
        use_motion_blur=cfg.use_motion_blur,
        generator=aug_generator(it, device))


def _step_kw(members) -> dict:
    from zebrapose_tpu_torch.train.trainer import _loss_cfg

    cfg = members[0].cfg
    return dict(loss_cfg=_loss_cfg(cfg),
                binary_loss_weight=float(cfg.binary_loss_weight),
                predict_entire_mask=cfg.predict_entire_mask,
                bf16=members[0].bf16)


def timed_fleet_steps(fleet: FleetResources, n_steps: int = 500,
                      warm: int = 20,
                      timing: Optional[Dict[str, float]] = None) -> float:
    """`trainer.timed_steps` for the fleet: `warm` unmeasured fleet
    steps, then `n_steps` timed ones; ms a fleet step on the host clock,
    from a drained device to the last step's losses read back. `timing`
    gets host_ms, wait_s and on CUDA event_ms. No checkpoints; the
    iterators stay open; the state advances."""
    state, members = fleet.state, fleet.rows
    dev = state.histogram.device
    kw = _step_kw(members)
    clock = {"wait_s": 0.0}
    for it in range(warm):
        fleet_train_step(state, fleet_batch(members, it, dev, clock), **kw)
    clock["wait_s"] = 0.0
    events = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    for it in range(warm, warm + n_steps):
        metrics = fleet_train_step(
            state, fleet_batch(members, it, dev, clock), **kw)
    if events is not None:
        events[1].record()
    metrics["loss_total"].cpu()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    if timing is not None:
        timing.update(host_ms=ms, wait_s=clock["wait_s"])
        if events is not None:
            timing["event_ms"] = events[0].elapsed_time(events[1]) / n_steps
    return ms


def fit_fleet(fleet: FleetResources, log_freq: int = 1000,
              validate: bool = True, max_steps: Optional[int] = None,
              timing: Optional[Dict[str, float]] = None) -> List[float]:
    """Train every member at once; returns each member's best recall.

    `trainer.fit`'s cadence with one `fleet_train_step` an iteration
    (batches from `fleet_batch`): every `log_freq` steps (and at the
    last) each member logs its metrics, histogram and per-step losses
    under its own logger, saves its own rolling `.pth` checkpoint, and
    after the fleet's pose validation its best one. `timing` gets fit's
    keys. In a world of several ranks every rank calls it: each trains,
    validates, logs and checkpoints the members it owns, and each
    returns the K members' bests."""
    t_run = time.perf_counter()
    members = fleet.members
    rows = fleet.rows
    state = fleet.state
    dev = state.histogram.device
    clock = dict.fromkeys(("wait_s", "step_s", "log_s", "val_s"), 0.0)
    start_step = state.step
    total = min(m.total_iterations for m in rows)
    end_step = total if max_steps is None else \
        min(start_step + max_steps, total)
    fleet_eval = None
    if validate and all(m.val_dataset is not None for m in rows):
        fleet_eval = fleet_eval_step(rows, state)
    best = list(state.best_score[:len(members)])
    step_losses = []
    kw = _step_kw(rows)
    try:
        for it in range(start_step, end_step):
            t0 = time.perf_counter()
            waited = clock["wait_s"]
            metrics = fleet_train_step(
                state, fleet_batch(rows, it, dev, clock), **kw)
            step_losses.append(metrics["loss_total"])
            clock["step_s"] += time.perf_counter() - t0 - (
                clock["wait_s"] - waited)

            if (it + 1) % log_freq == 0 or it + 1 == end_step:
                t0 = time.perf_counter()
                vals = {k: v.cpu().numpy() for k, v in metrics.items()}
                hist = state.histogram.cpu().numpy()
                losses = torch.stack(step_losses).cpu().numpy()
                steps = range(it + 2 - len(step_losses), it + 2)
                step_losses = []
                for i, m in enumerate(members):
                    scalars = {k: float(v[i]) for k, v in vals.items()}
                    scalars.update({f"bit_err_{j}": float(h)
                                    for j, h in enumerate(hist[i])})
                    m.logger.log(it + 1, scalars, prefix="train/")
                    m.logger.log_series("train/step_loss_total", steps,
                                        losses[:, i].tolist())
                    m.ckpt.save(index_state(state, i))
                clock["log_s"] += time.perf_counter() - t0

                t0 = time.perf_counter()
                if fleet_eval is not None:
                    val = _fleet_validate(rows, state, fleet_eval,
                                          fleet.first)
                    for i, m in enumerate(members):
                        prefix = "ADD-S" if m.symmetric else "ADD"
                        recall = val[i][f"{prefix}_recall_0.1d"]
                        m.logger.log(it + 1, val[i], prefix="val/")
                        if recall > best[i]:
                            best[i] = recall
                            state.best_score[i] = recall
                            m.ckpt.save_best(index_state(state, i), recall)
                clock["val_s"] += time.perf_counter() - t0
    finally:
        for m in members + ([fleet.ghost_source] if fleet.ghost_source
                            else []):
            m.train_iter.close()
            m.ckpt.wait()     # the writes in flight reach the disk
    if timing is not None:
        timing.update(clock, fit_s=time.perf_counter() - t_run,
                      steps=end_step - start_step)
    return [b for part in all_gather_object(best, fleet.world)
            for b in part]
