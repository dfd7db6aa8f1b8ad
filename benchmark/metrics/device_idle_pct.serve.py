"""The share of the profiled serving span in which no device operation
ran, %: one minus the union of the operations' intervals (overlaps
counted once) over the span."""


def read(run):
    prof = run.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
