"""Host CPU ms inside ``StreamingIngest.feed`` a pair, both sides summed
(each producer thread's CPU time around its call: the pairer's and the
ring's copies; a full ring's wait costs none), over the pairs that arrived
in the window."""

LAYER = "ingest (runtime/ingest.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "pairs_per_s"
BETTER = "lower"


def reads(config, traffic):
    return True


def read(run, cell):
    sel = (run.arrive >= run.t0) & (run.arrive <= run.t1)
    return float(run.feed_cpu_ms[sel].mean()) if sel.any() else None
