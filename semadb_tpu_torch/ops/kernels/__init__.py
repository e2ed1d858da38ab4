"""Hand-written CUDA kernels, each beside its plain PyTorch version."""

import importlib

# The kernels by their names in PERF.md, and the module of each wrapper
MODULES = {"K1": "hamming", "K2": "gather", "K3": "ivf_scan", "K4": "ivf_rerank", "K5": "ivf_probe_topk",
           "K9": "ivf_pq_scan", "K10": "vamana_search", "K11": "vamana_prune"}


def launch_counts() -> dict:
    """Each kernel's launches in this process so far (its wrapper's ``LAUNCHES``)."""
    return {name: importlib.import_module(f"{__name__}.{mod}").LAUNCHES for name, mod in MODULES.items()}
