"""A torch.distributed world of gloo ranks on the CPU for the port's
multi-process tests, and the functions its ranks run.

`spawn(fn, n, tmp, *args)` starts n fresh interpreters (the "spawn" start
method: nothing of the pytest worker is inherited, the stub `imgaug`
modules of tests/test_real_reference_module.py included), joins them in
a world over a `file://` rendezvous in `tmp`, runs `fn(world, *args)` on
each with one intra-op thread, and fails when a rank fails or the ranks
outlive `timeout` seconds (the others are killed at once when one
fails, so a rank left waiting in a collective does not hang the test).

The rank functions live here, not in the test modules, so a rank
imports torch, numpy and the port and nothing of JAX. They write what
the tests compare with `torch.save` under `tmp`.
"""

import hashlib
import multiprocessing
import os
import time

import numpy as np
import torch


def spawn(fn, n, tmp, *args, timeout=300):
    ctx = multiprocessing.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)     # the store's file goes there
    init = "file://" + os.path.join(str(tmp), "rendezvous")
    procs = [ctx.Process(target=_rank, args=(fn, r, n, init, args),
                         daemon=True) for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = any(p.exitcode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * n, f"ranks' exit codes {codes} (timeout {timeout} s)"


def _rank(fn, rank, n, init, args):
    torch.set_num_threads(1)
    from zebrapose_tpu_torch.parallel.mesh import (
        initialize_multihost,
        shutdown,
    )

    world = initialize_multihost(backend="gloo", device="cpu",
                                 init_method=init, rank=rank, world_size=n,
                                 timeout_s=240)
    try:
        fn(world, *args)
    finally:
        shutdown()


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's dtype, shape and values (bit equality)."""
    t = t.detach().contiguous().cpu()
    h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
    h.update(t.view(-1).view(torch.uint8).numpy().tobytes()
             if t.numel() else b"")
    return h.hexdigest()


def state_digests(state) -> dict:
    """Digests of a TrainState's weights, buffers, Adam moments and step
    counts, and histogram, by name."""
    out = {f"sd/{k}": digest(v) for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        for k, v in state.optimizer.state.get(p, {}).items():
            out[f"adam/{name}/{k}"] = digest(v)
    out["histogram"] = digest(state.histogram)
    out["step"] = str(state.step)
    return out


# ---------------------------------------------------------------------------
# the train step (tests/test_torch_multiproc.py)
# ---------------------------------------------------------------------------

def _v2_state(sd, world, lr, double=True):
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu_torch.train.state import create_train_state

    model = ZebraPoseNet(binary_code_length=16, variant="v2")
    model.load_state_dict(sd, strict=True)
    if double:
        model.double()
    return create_train_state(model, lr, n_bits=16, world=world)


def _rows(world, batch, double=True):
    from zebrapose_tpu_torch.parallel.mesh import shard_batch

    rows = shard_batch(world, batch)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.float64 if double else torch.float32) for k, v in rows.items()}


def step_f64(world, tmp):
    """One optimizer step of ZebraPoseNet v2 in float64 over the world,
    each rank on its rows of each global micro-batch in
    `tmp/inputs.pt`; writes the metrics and the state's digests, and on
    rank 0 the applied gradient (Adam's first moment / 0.1), the BN
    statistics and the histogram."""
    from zebrapose_tpu_torch.models.losses import CodeLossConfig
    from zebrapose_tpu_torch.train.train_step import accum_train_step

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    state = _v2_state(inp["sd"], world, inp["lr"])
    metrics = accum_train_step(state, [_rows(world, b)
                                       for b in inp["micro"]],
                               CodeLossConfig())
    params = dict(state.model.named_parameters())
    rec = {"metrics": {k: float(v) for k, v in metrics.items()},
           "step": state.step, "digests": state_digests(state)}
    if world.is_main:     # the others' are the same bits (the digests)
        rec.update(
            grads={n: state.optimizer.state[p]["exp_avg"] / 0.1
                   for n, p in params.items()},
            stats={k: v for k, v in state.model.state_dict().items()
                   if k.endswith(("running_mean", "running_var"))},
            histogram=state.histogram)
    torch.save(rec, os.path.join(tmp, f"rank{world.rank}.pt"))


def global_histogram(world, tmp):
    """total_loss on this rank's rows of `tmp/outputs.pt` over the world,
    and on its own (this rank's own histogram)."""
    from zebrapose_tpu_torch.models.losses import CodeLossConfig, total_loss
    from zebrapose_tpu_torch.parallel.mesh import shard_batch

    inp = torch.load(os.path.join(tmp, "outputs.pt"), weights_only=False)
    out = shard_batch(world, inp["outputs"])
    gt = shard_batch(world, inp["gt"])
    hist0 = inp["histogram"]
    res = {}
    for tag, w in (("global", world), ("local", None)):
        _, hist, metrics = total_loss(out, gt["mask"], gt["entire_mask"],
                                      gt["code"], hist0, CodeLossConfig(),
                                      world=w)
        res[tag] = {"histogram": hist, "hamming": float(metrics["hamming"])}
    torch.save(res, os.path.join(tmp, f"rank{world.rank}.pt"))


def replicas(world, tmp):
    """Each rank initialises its own weights (seed = rank), `replicate`
    gives every rank rank 0's, then three float32 steps on the ranks'
    rows of three batches: writes digests of everything the state
    carries after the replicate and after the steps."""
    from zebrapose_tpu_torch.models.losses import CodeLossConfig
    from zebrapose_tpu_torch.models.zebra_net import ZebraPoseNet
    from zebrapose_tpu_torch.parallel.mesh import replicate
    from zebrapose_tpu_torch.train.state import create_train_state
    from zebrapose_tpu_torch.train.train_step import train_step

    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    torch.manual_seed(world.rank)
    model = ZebraPoseNet(binary_code_length=16, variant="v2")
    state = create_train_state(model, inp["lr"], n_bits=16, world=world)
    mine = state_digests(state)
    replicate(world, state)
    start = state_digests(state)
    losses = [float(train_step(state, _rows(world, b, double=False),
                               CodeLossConfig())["loss_total"])
              for b in inp["batches"]]
    end, step = state_digests(state), state.step
    state.step += world.rank       # as if rank 1 restored a later file
    try:
        replicate(world, state)
        refused = False
    except ValueError as e:
        refused = "different steps" in str(e)
    torch.save({"own": mine, "start": start, "end": end, "losses": losses,
                "step": step, "refused": refused},
               os.path.join(tmp, f"rank{world.rank}.pt"))


def train_setup_draws(world, tmp, cfg_dict, out):
    """build_train_setup over the world (stream and device_cache): this
    rank's first two draws, the world-scaled lr and iterations, whether
    it writes, and its state's digests."""
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.train.trainer import build_train_setup

    cfg = ZebraConfig.from_dict(cfg_dict)
    res = {}
    for mode in ("stream", "device_cache"):
        r = build_train_setup(cfg, "ape", os.path.join(out, mode),
                              pretrained_backbone=None, world=world,
                              device_cache=mode == "device_cache")
        res[mode] = {"draws": [next(r.train_iter) for _ in range(2)],
                     "lr": r.state.schedule(0),
                     "iters": r.total_iterations,
                     "writes": r.ckpt.write,
                     "digests": state_digests(r.state)}
        r.train_iter.close()
        r.ckpt.close()
        r.logger.close()
    torch.save(res, os.path.join(tmp, f"rank{world.rank}.pt"))


# ---------------------------------------------------------------------------
# the fleet (tests/test_torch_fleet_world.py)
# ---------------------------------------------------------------------------

def inject_fleet_augmentation(names):
    """Replace `train/fleet.py::fleet_batch` with one that augments each
    member's rows with its own generator, seeded from (step, the
    member's fleet index): a member's batch then does not depend on the
    rows it shares a batch with, so fleets laid out differently over
    ranks draw the same member batches. A ghost row (member K-1's
    resources) draws member K-1's."""
    from zebrapose_tpu_torch.data.pipeline import FEED_KEYS, preprocess_batch
    from zebrapose_tpu_torch.train import fleet
    from zebrapose_tpu_torch.train.trainer import aug_generator

    def fleet_batch(members, it, device, clock=None):
        cfg = members[0].cfg
        drawn = {}
        out = []
        for m in members:
            if id(m) not in drawn:
                drawn[id(m)] = next(m.train_iter)
            raw = drawn[id(m)]
            feed = {k: torch.as_tensor(raw[k]).to(device) for k in FEED_KEYS}
            out.append(preprocess_batch(
                feed, crop_img=cfg.BoundingBox_CropSize_image,
                crop_gt=cfg.BoundingBox_CropSize_GT,
                base=cfg.divide_number_each_itration,
                n_bits=cfg.number_of_itration,
                resize_method=cfg.resize_method, is_train=True,
                generator=aug_generator(
                    1000 * it + names.index(m.obj_name), device)))
        return {k: torch.cat([o[k] for o in out]) for k in out[0]}

    fleet.fleet_batch = fleet_batch


def fleet_fit(world, tmp, cfg_dict, names, out, steps, save=True):
    """build_fleet_setup over the world, `steps` fleet steps with the
    injected augmentation and one pose validation at the last; writes
    this rank's rows' digests (index_state), fleet indices, the bests
    fit_fleet returns and the fleet's layout. save=False: the members
    write no checkpoints (~0.3 GB each)."""
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.train import fleet

    inject_fleet_augmentation(list(names))
    cfg = ZebraConfig.from_dict(cfg_dict)
    fr = fleet.build_fleet_setup(cfg, list(names), out, world=world,
                                 pretrained_backbone=None)
    for m in fr.members:
        m.ckpt.write = save
    best = fleet.fit_fleet(fr, log_freq=steps, max_steps=steps)
    rows = [state_digests(fleet.index_state(fr.state, i))
            for i in range(len(fr.state.members))]
    torch.save({"rows": rows, "first": fr.first, "n_pad": fr.n_pad,
                "members": [m.obj_name for m in fr.members],
                "ghost_source": getattr(fr.ghost_source, "obj_name", None),
                "best": best},
               os.path.join(tmp, f"rank{world.rank}.pt"))
    for m in fr.members:
        m.ckpt.close()
        m.logger.close()


def oracle_fleet(oracle_files):
    """Make `eval/fleet_serve.py` run oracle networks: a checkpoint path
    in `oracle_files` names a file of one object's oracle logits ({"mask"
    [h, w], "code" [h, w, bits]}), `_fleet_model` stacks those, and the
    fleet step's forward broadcasts them over the batch."""
    from zebrapose_tpu_torch.eval import fleet_serve as tfs

    real = tfs.make_fleet_eval_step

    def oracle_forward(batch, variables):
        n = batch["image"].shape[0]
        m = variables["mask"][None, ..., None].expand(n, -1, -1, 1)
        return {"mask": m, "entire_mask": m,
                "code": variables["code"][None].expand(n, -1, -1, -1)}

    def fleet_model(cfg, variant, ckpt_files, dev, quant=False):
        logits = [torch.load(f, weights_only=True) for f in ckpt_files]
        return None, {k: torch.stack([x[k] for x in logits]).to(dev)
                      for k in ("mask", "code")}

    tfs._fleet_model = fleet_model
    tfs.make_fleet_eval_step = lambda fwd, *a, **kw: real(
        oracle_forward, *a, **kw)


def fleet_eval(world, tmp, cfg_dict, test_names, vivo_names, ckpts, out,
               pnp):
    """run_test_fleet and run_vivo_fleet over the world with oracle
    networks (`oracle_fleet`); writes what each rank got back."""
    from zebrapose_tpu_torch.config import ZebraConfig
    from zebrapose_tpu_torch.eval import fleet_serve as tfs
    from zebrapose_tpu_torch.ops.pnp import PnPConfig

    oracle_fleet(list(ckpts.values()))
    cfg = ZebraConfig.from_dict(cfg_dict)
    kw = dict(batch_size=2, pnp_cfg=PnPConfig(**pnp), world=world)
    got = {"test": tfs.run_test_fleet(
        cfg, list(test_names), [ckpts[n] for n in test_names],
        os.path.join(out, "test"), **kw)}
    got["vivo"] = tfs.run_vivo_fleet(
        cfg, list(vivo_names), [ckpts[n] for n in vivo_names],
        os.path.join(out, "vivo"), **kw)
    torch.save(got, os.path.join(tmp, f"rank{world.rank}.pt"))
