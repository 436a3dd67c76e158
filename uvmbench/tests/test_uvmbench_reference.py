"""The reference's rows equal the port's rows on its NumPy engine, single
tenant and two-tenant (shared capacity and hard quotas)."""

from uvmbench.reference import sweep_pass as ref

CELLS = [
    ("ATAX", "none", "lru", None), ("ATAX", "tree", "random", None),
    ("Pathfinder", "oracle", "hotcold", None),
    ("BICG", "block", "lru", None),
    ("ATAX+Pathfinder", "tree", "lru", "shared"),
    ("ATAX+Pathfinder", "oracle", "random", "0.5/0.5"),
    ("MVT+StreamTriad", "tree", "lru", "0.4/0.4"),
    ("MVT+StreamTriad", "block", "hotcold", "0.5/0.5"),
]


def test_reference_rows_equal_the_numpy_engines(bench):
    from repro_torch.uvm import sweep
    from uvmbench import spec
    uvm = spec.config("paper11", bench)["uvm"]
    cells = [dict(bench=b, prefetcher=pf, scale=0.25, seed=3, window=0.6,
                  device_frac=0.5, eviction=ev, capacity_split=split)
             for b, pf, ev, split in CELLS]
    rows = sweep.run_sweep([sweep.SweepCell(backend="numpy", **c)
                            for c in cells], device="cpu")
    for cell, row in zip(cells, rows):
        assert row["backend"] == "numpy"
        want = ref.reference_row(cell, uvm)
        assert ref.compare_row(row, want) == (0, 0.0), cell


def test_float32_clock_departs_from_the_reference(bench):
    from uvmbench import spec
    uvm = spec.config("paper11", bench)["uvm"]
    cell = dict(bench="ATAX", prefetcher="tree", scale=0.25, seed=3,
                window=0.6, device_frac=0.5, eviction="lru",
                capacity_split=None)
    bad, gap = ref.compare_row(ref.reference_row(cell, uvm, "float32"),
                               ref.reference_row(cell, uvm))
    assert bad or gap > 1e-6


def test_compare_row_counts_fields():
    row = dict(bench="ATAX", prefetcher="none", scale=1.0, seed=0,
               window=0.6, device_frac=0.5, eviction="lru",
               capacity_split=None, device_pages=10, n_accesses=100,
               n_instructions=7, hits=3, late=0, faults=1,
               prefetch_issued=0, prefetch_used=0, pages_migrated=1,
               pages_evicted=0, tenants=None, cycles=1000.0, ipc=0.007,
               hit_rate=0.03, accuracy=1.0, coverage=0.0, unity=0.0,
               pcie_bytes=4096.0, hit_rate_t0=None, hit_rate_t1=None,
               slowdown_t0=None, slowdown_t1=None,
               interference_slowdown=None)
    assert ref.compare_row(row, row) == (0, 0.0)
    assert ref.compare_row(dict(row, hits=4), row) == (1, 0.0)
    assert ref.compare_row(dict(row, cycles=1001.0), row) == (0, 1e-3)
    assert ref.compare_row(dict(row, slowdown_t0=1.0), row) == (1, 0.0)
    n = len(ref.ID_FIELDS) + len(ref.INT_FIELDS) + len(ref.FLOAT_FIELDS)
    assert ref.compare_row(None, row) == (n, 0.0)
