"""The slab step with the non-pressure forces, on the CPU.

``tests/test_torch_parallel.py``'s slab-step check (2 and 4 slabs under
``LocalHalos`` against the world's single-device step, at
``tests/test_domain.py``'s bounds, identical iterations and contacts at
every step) for ``tests/test_domain.py``'s forces one at a time (XSPH,
Akinci, He 2014, the DFSPH viscosity at one iteration) and for every
halo-aware force at once under each solver. A file of its own, so that
the suite's workers share the slab tests' time.
"""

import pytest

from test_torch_parallel import BASE_CASES, CASES, check_slab_step


@pytest.mark.parametrize("n_slabs", [2, 4])
@pytest.mark.parametrize("case", [c for c in CASES if c not in BASE_CASES])
def test_slab_step_with_forces_matches_single_device(case, n_slabs):
    check_slab_step(case, n_slabs)
