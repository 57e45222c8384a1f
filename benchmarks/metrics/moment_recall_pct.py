"""moment_recall_pct (%): the share of the reference's exact top-N
(video, st, ed) moments, over its own exact top-V videos, that the
program returned, over the checked queries (``benchmarks.check``)."""


def read(run):
    return run.numbers.get("moment_recall_pct")
