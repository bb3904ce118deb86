"""The comparison that decides ``correct``: each kept answer of the window
is judged against the plain reference (``mgbench/reference``), and each
number is held to its limit from the traffic mix's ``checks``. A number
is a file ``checks/<name>.py`` whose ``read(u, f, k, conf)`` judges one
answer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from . import spec


def judge(checks: List[Dict], answers, conf: Dict
          ) -> Dict[str, Tuple[float, float]]:
    """{number: (largest reading over ``answers``, limit)}; ``answers``
    yields (u, f, k) on the card, one at a time."""
    readers = {c["number"]: spec.check_reader(c["number"]) for c in checks}
    worst = {c["number"]: 0.0 for c in checks}
    for u, f, k in answers:
        for name, read in readers.items():
            v = read(u, f, k, conf)
            if not math.isfinite(v):
                v = math.inf
            worst[name] = max(worst[name], v)
    return {c["number"]: (worst[c["number"]], float(c["limit"]))
            for c in checks}


def passed(numbers: Dict[str, Tuple[float, float]]) -> bool:
    return all(v <= lim for v, lim in numbers.values())
