"""Where the float64 elliptic Newton counts of the port and of the JAX
package part (parity's 'elliptic64' bar), on stack_4.

``tests/measure_elliptic_counts.py`` measures it over four seeds of 32
worlds: the counts of the JAX ``solve`` and of the same JAX functions run
one trip at a time part too (in 0-2 worlds of 32), and in every world
whose counts part no stop quantity lies within 1e6 of the tolerance
before the last trip.  The trips part in the linesearch: here, in world
6 of seed 3, the two sides' first search directions agree to 2.4e-16 of
their scale, and the port's linesearch (the JAX one, step for step) from
the port's lands on the exact minimizer, whose slope is zero up to
rounding, while from the JAX one it rejects that point (its slope rounds
the other way, and the bracket has closed on one point) and stops a long
way short, at a slope of -9.8e5.  The Newton then needs another trip.
"""

import pytest

from tests import measure_elliptic_counts as mc
from tests.torch_threads import few_threads  # noqa: F401

pytest.importorskip('dm_control')


def test_count_spread_is_the_linesearch_knife_edge():
  m, d = mc.system(3, 32)
  out = mc.first_linesearch(m, d, 6)
  assert out['search_diff'] <= 1e-15 * out['search_scale']
  alpha_port, steps_port = out['port']
  alpha_jax, steps_jax = out['jax']
  lo_alpha, lo_slope, hi_alpha, hi_slope, swapped, done = steps_port[-1]
  assert done and lo_alpha == alpha_port and abs(lo_slope) < 1e-6
  lo_alpha, lo_slope, hi_alpha, hi_slope, swapped, done = steps_jax[-1]
  assert done and not swapped and lo_alpha == hi_alpha == alpha_jax
  assert lo_slope < -1e5
  assert alpha_port - alpha_jax > 0.1
