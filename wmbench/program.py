"""The program's own spans and counters over a traced run's timed window.

With --trace 1 the harness hands every request of the window a `marks`
list. The program (hunyuanworld_mirror_tpu_torch/utils/profiling.request)
then records the request's whole span tree and its counters into its
recorder `profiling.marked`, whose last len(run.spans) requests are the
window's. A program without that recorder gives nothing, and the readers
built on this return None.
"""

from typing import List, Optional


def window(run) -> List:
    """The window's recorded requests (profiling.Request), resolved: its
    last ones where the recorder kept fewer; [] if the program recorded
    none."""
    n = len(run.spans)
    if not n:
        return []
    try:
        from hunyuanworld_mirror_tpu_torch.utils import profiling
    except ImportError:
        return []
    rec = getattr(profiling, "marked", None)
    if rec is None or not hasattr(rec, "resolve"):
        return []
    return rec.resolve()[-n:]


def mean_ms(run, *names: str) -> Optional[float]:
    """The mean a request of the summed ms of its spans named `names` (over
    every camera where a span runs once a camera), over the requests that
    hold one."""
    reqs = [r for r in window(run) if any(s.name in names for s in r.spans)]
    return sum(r.ms(*names) for r in reqs) / len(reqs) if reqs else None


def mean_count(run, name: str) -> Optional[float]:
    """The mean a request of the program's counter `name`."""
    reqs = window(run)
    return sum(r.counts.get(name, 0) for r in reqs) / len(reqs) if reqs else None
