"""Host ms the consumer waits on ``frames_prefetch`` for the next staged pair,
a pair, over the window: how far the ingest and the uploader hold the frame
step back."""

LAYER = "ingest (runtime/ingest.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "pairs_per_s"
BETTER = "lower"


def reads(config, traffic):
    return True


def read(run, cell):
    n = run.span_pairs("staged_wait")
    return 1e3 * run.span_total("staged_wait") / n if n else None
