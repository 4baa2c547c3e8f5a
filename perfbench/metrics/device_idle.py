"""``device_idle.<suffix>``: the share of the profiled stretch in which no
operation ran on the card, in %: 100 (1 - busy / stretch), busy the union of
every device operation's interval in the ``torch.profiler`` trace."""


def read(run, suffix):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
