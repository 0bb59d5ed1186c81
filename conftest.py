"""Fixtures for every test module of the repository."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def _port_sites_as_found():
    """Leave the port's probe-site registry as the module found it.

    A site's id is the order in which its name was first registered in
    the process. Some tests hold the port's ids against the JAX package's,
    whose registry only that package's runs fill; a module that ran
    earlier in the same worker and registered sites of the port alone
    would shift the port's ids."""
    try:
        from repro_torch.core.events import SITES
    except ImportError:             # no torch, or src/ not on the path
        yield
        return
    ids, names = dict(SITES._ids), list(SITES._names)
    yield
    SITES._ids.clear()
    SITES._ids.update(ids)
    SITES._names[:] = names
