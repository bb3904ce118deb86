"""The byte counts of each stage against counts made by hand."""

import pytest

from mgbench.harness import work

CONF3 = {"n": 9, "dims": 3, "level_dtype": "float32", "tail_entry": None}
CONF2 = {"n": 17, "dims": 2, "level_dtype": "float32", "tail_entry": 5}


def test_level_sizes():
    assert work.level_sizes(513) == [513, 257, 129, 65, 33, 17, 9, 5, 3]
    assert work.level_sizes(2049)[-1] == 3
    assert len(work.level_sizes(2049)) == 11
    assert work.level_sizes(3) == [3]


def test_upper_levels():
    assert work.upper_levels(CONF3) == 2           # 9, 5 above the 3^3
    assert work.upper_levels(CONF2) == 2           # 17, 9 above tail 5
    assert work.upper_levels({**CONF2, "n": 2049, "tail_entry": 129}) == 4


def test_cycle_bytes_3d_by_hand():
    # levels 9^3, 5^3, 3^3; fp32
    n0, n1, n2 = 729, 125, 27
    smooth = 4 * (2 * 3 * n0 + 2 * 3 * n1 + 3 * n2)
    transfer = 4 * ((2 * n0 + n1) + (n1 + 2 * n0)
                    + (2 * n1 + n2) + (n2 + 2 * n1))
    assert work.cycle_bytes(CONF3, 0) == {"smooth": smooth,
                                          "transfer": transfer}
    # a cycle on the coarsest level is one smoothing call
    assert work.cycle_bytes(CONF3, 2) == {"smooth": 4 * 3 * n2,
                                          "transfer": 0}


def test_cycle_bytes_2d_by_hand():
    # levels 17^2, 9^2 above the tail; 5^2 is the tail's entry
    n0, n1, n2 = 289, 81, 25
    smooth = 4 * (2 * 3 * n0 + 2 * 3 * n1)
    transfer = 4 * ((2 * n0 + n1) + (n1 + 2 * n0)
                    + (2 * n1 + n2) + (n2 + 2 * n1))
    assert work.cycle_bytes(CONF2, 0) == {"smooth": smooth,
                                          "transfer": transfer}
    assert work.cycle_bytes(CONF2, 1) == {
        "smooth": 4 * 2 * 3 * n1, "transfer": 4 * (2 * (2 * n1 + n2))}
    # a cycle that starts in the tail is the tail's alone
    assert work.cycle_bytes(CONF2, 2) == {"smooth": 0, "transfer": 0}


@pytest.mark.parametrize("dtype,size", [("float32", 4), ("bfloat16", 2),
                                        ("float64", 8)])
def test_bytes_scale_with_storage(dtype, size):
    c = work.cycle_bytes({**CONF3, "level_dtype": dtype}, 0)
    c4 = work.cycle_bytes(CONF3, 0)
    assert c["smooth"] * 4 == c4["smooth"] * size


def test_solve_bytes_follow_the_plan():
    ir = {"plan": {"fmg": False, "cycles_per_iteration": 2}}
    fmg = {"plan": {"fmg": True, "cycles_per_iteration": 2}}
    one = work.cycle_bytes(CONF3, 0)
    b = work.solve_bytes(CONF3, ir, 5)
    assert b == {k: 10 * v for k, v in one.items()}
    # FMG adds one cycle started on every level
    b2 = work.solve_bytes(CONF2, fmg, 3)
    want = {k: 0 for k in one}
    for lvl, starts in enumerate([7, 1, 1, 1]):  # 17, 9, 5, 3
        for k, v in work.cycle_bytes(CONF2, lvl).items():
            want[k] += starts * v
    assert b2 == want
    assert work.cycle_starts(CONF2, fmg, 3) == [7.0, 1.0, 1.0, 1.0]
