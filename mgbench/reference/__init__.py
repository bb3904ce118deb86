"""Plain reference for the benchmark's correctness check.

Plain PyTorch on the constant-coefficient Poisson operators that the cells
solve. It imports nothing of the program under test and takes nothing the
program made: it rebuilds each operator from the grid size alone.
"""
