"""UVM substrate of the port: the legacy page-granular simulator (a copy of
the reference's, the port's own cross-check) and the golden matrix, the
``cuda`` multi-lane replay backend around kernel K1, the prediction cache,
the sweep entry point (``python -m repro_torch.uvm.sweep``), its scenarios
and the paper's Table 10/11."""
