"""Release jax's compiled executables when a test process holds too many
memory maps.

Every executable XLA compiles for the CPU keeps its machine code in
memory maps of its own (about 350 maps for one compile of the
reference's ``Scheduler.run``), and jax's caches keep every executable
alive for the life of the process.  A test worker that compiles a few
hundred of them reaches the kernel's ``vm.max_map_count`` (65,530 by
default), and the next compile dies with a segmentation fault inside
``backend_compile_and_load``.  The port's parity test modules import
this fixture: after each of their tests, a process holding more than
``MAX_MAPS`` maps clears jax's caches (a later call compiles again).
"""

import jax
import pytest

#: a third of the default ``vm.max_map_count``: one test's compiles stay
#: far below the other two thirds
MAX_MAPS = 20_000


def _maps() -> int:
    """Memory maps this process holds (0 where /proc is not there)."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def release_compiled():
    yield
    if _maps() > MAX_MAPS:
        jax.clear_caches()
