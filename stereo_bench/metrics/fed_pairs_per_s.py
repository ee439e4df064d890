"""Pairs published a second over the window's whole seconds in which the card
never ran dry (each dispatch in the second found steps still queued on it):
the pace of the card where the host kept up, steadier than ``pairs_per_s``
on a host that slows for seconds at a time.  None where no second was fed
(on a host device nothing is queued)."""

from stereo_bench import loop

LAYER = "device (one H100)"
UNIT = "pairs/s"
SOURCE = "host_clock"
MOVES = "pairs_per_s"
BETTER = "higher"


def reads(config, traffic):
    return True


def read(run, cell):
    fed = [k for k, n in loop.least_a_second(run).items() if n >= 1]
    if not fed:
        return None
    t = run.done - run.t0
    return sum(int(((t >= k) & (t < k + 1)).sum()) for k in fed) / len(fed)
