"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

* K1 ``lane_replay`` -- multi-lane UVM replay (replaces the reference's
  Pallas ``_lane_replay_fn``), host side in ``repro_torch.uvm.backends``.
* K2 ``hlsh_attention`` -- HLSH masked attention (replaces the reference's
  Pallas ``_hlsh_kernel``); ``ops.hlsh_attention`` adds the share map.
* K3 ``int4_matmul`` -- packed-int4 weight matmul (replaces the reference's
  Pallas ``_int4_kernel``).
* K4 ``flash_attention`` -- online-softmax multi-head attention (replaces
  the reference's Pallas ``_flash_kernel``).

Sources live in ``repro_torch/csrc``; ``build`` compiles each with nvcc into
a shared library with a plain C interface at first use.  A wrapper launches
its kernel for CUDA tensors and runs the plain version for CPU tensors, and
counts its launches in its ``launches`` attribute.

Where a sweep's kernels run in processes of their own (a sweep CLI, its
lease workers), ``log_launches`` lets the caller read those counts: with
``REPRO_LAUNCH_LOG`` naming a directory, a process that runs sweep cells
keeps its cumulative counts in ``<dir>/<pid>.json``, rewritten as it goes,
and ``read_launch_log`` sums them.
"""
import json
import os
import sys
from typing import Dict

LAUNCH_LOG_ENV = "REPRO_LAUNCH_LOG"


_WRAPPERS = ("lane_replay", "hlsh_attention", "int4_matmul",
             "flash_attention")


def launch_counts() -> Dict[str, int]:
    """This process's launch counts of K1-K4, by wrapper name (0 for a
    kernel whose module this process never imported: nothing is imported
    here, so a lease worker logs at once when its cell ends)."""
    out = {}
    for name in _WRAPPERS:
        module = sys.modules.get(f"{__name__}.{name}")
        out[name] = getattr(module, name).launches if module else 0
    return out


def log_launches() -> None:
    """Write this process's launch counts to ``<dir>/<pid>.json`` when
    ``REPRO_LAUNCH_LOG`` names ``dir`` (atomically: a process killed
    mid-write leaves its previous counts)."""
    log_dir = os.environ.get(LAUNCH_LOG_ENV)
    if not log_dir:
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(launch_counts(), f)
    os.replace(path + ".tmp", path)


def read_launch_log(log_dir: str) -> Dict[str, int]:
    """The launch counts of every process logged under ``log_dir``,
    summed by wrapper name."""
    total = {name: 0 for name in launch_counts()}
    for name in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else ():
        if name.endswith(".json"):
            with open(os.path.join(log_dir, name)) as f:
                for key, n in json.load(f).items():
                    total[key] += n
    return total

