"""The other half of the golden cells for the port's NumPy chunked engine
(see ``test_torch_engine.py``): equal to the reference's NumPy engine and to
the port's legacy engine; and the engine's invariants on every golden cell
with its strict checks on (monotone clock, no in-flight page evicted)."""
import pytest

pytest.importorskip("torch")

from test_torch_engine import CELLS, check_golden_cell

from repro_torch.uvm import VectorizedUVMSimulator
from repro_torch.uvm import golden as G


@pytest.mark.parametrize("cell_id", CELLS[1::2])
def test_numpy_engine_equals_the_reference_and_legacy(cell_id):
    check_golden_cell(cell_id)


@pytest.mark.parametrize("cell_id", CELLS)
def test_invariants(cell_id):
    trace, config, factory = G.golden_cell(cell_id)
    st = VectorizedUVMSimulator(config, strict_checks=True).run(
        trace, factory())
    assert st.backend == "numpy"
    assert st.hits + st.late + st.faults == st.n_accesses
    assert 0.0 <= st.accuracy <= 1.0
    assert 0.0 <= st.coverage <= 1.0
    assert 0.0 <= st.hit_rate <= 1.0
    assert 0.0 <= st.unity <= 1.0
    assert st.prefetch_used <= st.prefetch_issued
    assert st.pages_migrated >= st.faults
    assert st.cycles >= 0.0
    if config.device_pages is not None:
        assert st.pages_migrated - st.pages_evicted >= 0
