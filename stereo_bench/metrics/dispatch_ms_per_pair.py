"""Host ms inside ``process_batch`` or ``process`` a pair, over the window
(the wait for a step in flight is its own span, outside this one)."""

LAYER = "frame step (models/pipeline.py, utils/graphs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "pairs_per_s"
BETTER = "lower"


def reads(config, traffic):
    return True


def read(run, cell):
    n = run.span_pairs("dispatch")
    return 1e3 * run.span_total("dispatch") / n if n else None
