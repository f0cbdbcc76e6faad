"""Solver termination status codes.

The port's own copy of the JAX package's ``Status`` enum, with the same
integer values, so a status read from one package compares equal to the
other's.

  CONVERGED       b_low <= b_high + 2*tau
  NO_WORKING_SET  I_high or I_low is empty
  INFEASIBLE_UV   the pair's box [U, V] is empty (U > V + 1e-12)
  NONPOS_ETA      eta <= eps for the selected pair
  MAX_ITER        the update or outer-round budget ran out
  STALLED         the selected pair's update rounded to exactly zero
"""

import enum


class Status(enum.IntEnum):
    RUNNING = 0
    CONVERGED = 1
    NO_WORKING_SET = 2
    INFEASIBLE_UV = 3
    NONPOS_ETA = 4
    MAX_ITER = 5
    STALLED = 6
