"""The storages the 2D smoothers' wrappers ask for are compiled in.

Kernels A (``mg_smooth``), L (``mg_rbgs_parity``) and H (``mg_smooth_var``)
take u and f each in fp32 or bf16, as the Pallas kernels cast each on its
own; the output keeps u's dtype. A call of several launches runs its passes
before the last on fp32 scratch fields, so each launch names its own
storage (``smooth.pass_storages``, ``smooth_var.pass_storages``). For every
pairing of u and f and every sweep count up to three launches, each storage
code a launch is given must be a case of the entry's switch, typed as the
code's bits say, and compiled for that launch's sweep count. Read from the
sources: there is no compiler here.
"""

import itertools
import re
from pathlib import Path

import pytest
import torch

import mixed_precision_multigrid_solvers_for_pdes_torch as T
from mixed_precision_multigrid_solvers_for_pdes_torch.ops.cuda_kernels import (
    smooth as ksmooth,
    smooth_var as ksmooth_var,
)

CSRC = Path(T.__file__).parent / "csrc"
STORAGES = (torch.float32, torch.bfloat16)
# entry: (source, its wrapper's module, the template parameters of the
# typed function each case returns)
ENTRIES = {
    "mg_smooth": ("smooth.cu", ksmooth, ("TU", "TF", "TO", "any")),
    "mg_rbgs_parity": ("smooth_parity.cu", ksmooth,
                       ("planes", "TU", "TF", "TO", "any")),
    "mg_smooth_var": ("smooth_var.cu", ksmooth_var, ("TU", "TF", "TP", "TO")),
}
BITS = {"TU": 0, "TF": 1, "TO": 2, "TP": 3}


def compiled(entry: str) -> dict:
    """{storage code: {template parameter: argument}} of the entry's
    switch."""
    src, _, params = ENTRIES[entry]
    text = (CSRC / src).read_text()
    body = text[text.index(f"int {entry}("):]
    body = body[:body.index("\n}\n")]
    values = {name: int(v) for name, v in
              re.findall(r"^\s+(k\w+) = (\d+),", text, re.M)}
    cases = re.findall(r"case (k\w+):\s*return (?:\(int\))?\w+<([^>]*)>",
                       body)
    assert cases, entry
    return {values[name]: dict(zip(params, (a.strip() for a in
                                            args.split(","))))
            for name, args in cases}


def needed(module, u_dtype, f_dtype):
    """(storage code, sweeps) of every launch of every call of 1 ..
    3 MAX_SWEEPS sweeps on a u and an f of these dtypes."""
    out = set()
    for sweeps in range(1, 3 * module.MAX_SWEEPS + 1):
        passes = module.plan_passes(sweeps)
        codes = module.pass_storages(u_dtype, f_dtype, len(passes))
        out |= set(zip(codes, passes))
    return out


def missing(entry, u_dtype, f_dtype) -> list:
    _, module, params = ENTRIES[entry]
    cases = compiled(entry)
    bad = []
    for code, sweeps in sorted(needed(module, u_dtype, f_dtype)):
        args = cases.get(code)
        if args is None:
            bad.append((code, sweeps, "no case"))
            continue
        for p, bit in BITS.items():
            if p in params and args[p] != ("bf16" if code >> bit & 1
                                           else "float"):
                bad.append((code, sweeps, f"{p} is {args[p]}"))
        if "any" in params and sweeps != ksmooth.MAX_SWEEPS \
                and args["any"] != "true":
            bad.append((code, sweeps, f"compiled for {ksmooth.MAX_SWEEPS} "
                        "sweeps only"))
    return bad


@pytest.mark.parametrize("u_dtype,f_dtype",
                         list(itertools.product(STORAGES, STORAGES)),
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_every_pairing_is_compiled(entry, u_dtype, f_dtype):
    assert missing(entry, u_dtype, f_dtype) == []


def test_the_check_sees_a_missing_case():
    """The check has teeth: a bf16 u over an fp32 f needs codes 5, 1 and 4
    of A, which the test's reading of the source must find."""
    codes = {c for c, _ in needed(ksmooth, torch.bfloat16, torch.float32)}
    assert codes == {5, 1, 4, 0}
    assert {5, 1, 4} <= set(compiled("mg_smooth"))
    assert {c for c, _ in needed(ksmooth, torch.float32,
                                 torch.bfloat16)} == {2}
    assert {c for c, _ in needed(ksmooth_var, torch.bfloat16,
                                 torch.float32)} == {13, 9, 8, 12}
