"""Host ms inside ``enqueue_send`` a pair, over the window: the host copies'
start on the copy stream and the sends handed to the sender workers."""

LAYER = "publish (utils/hostcopy.py, utils/msgs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "pairs_per_s"
BETTER = "lower"


def reads(config, traffic):
    return True


def read(run, cell):
    n = run.span_pairs("enqueue")
    return 1e3 * run.span_total("enqueue") / n if n else None
