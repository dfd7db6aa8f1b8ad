"""A tiny cell for the CPU tests: the repository's configuration and a
traffic mix at a size the CPU runs in seconds."""

from __future__ import annotations


class TinyCell:
    """A cell of the repository's configuration and traffic at a size the
    CPU runs in seconds: 128² crops (64² outputs), a few crops a batch,
    a subset of 512 correspondences (so the subset path runs)."""

    def __init__(self, config: str, traffic: dict):
        from benchmark import harness

        self.name, self.chips = "tiny", 1
        self.config = harness.load_json(harness.BENCH / "configs" / config)
        self.config["shapes"].update(crop_img=128, crop_gt=64)
        self.config["pnp"]["max_points"] = 512
        self.traffic = traffic
        self._e2e = [{"name": n, "unit": u} for n, u in (
            ("crops_per_s", "crops/s"), ("batch_p95_ms", "ms"),
            ("train_samples_per_s", "samples/s"), ("setup_s", "s"))]

    def end_to_end(self):
        return self._e2e

    def per_layer(self):
        return []


SERVE_TINY = {"driver": "serve", "batch": 3, "pool_frames": 8, "ring": 2,
              "scaled_share": 0.34, "warmup_batches": 1, "capture": 2,
              "capture_from": 0, "capture_span": 3, "profile_from": 1,
              "profile_batches": 2}
TRAIN_TINY = {"driver": "train", "batch": 4, "frames": 6,
              "checked_steps": 3, "warmup_steps": 1, "profile_from": 1,
              "profile_steps": 1}
