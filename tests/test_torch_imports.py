"""The port stands apart from JAX and from the JAX package.

An ``ast`` walk of ``semadb_tpu_torch/`` and ``chip_smoke.py`` finds no
``jax`` import and no ``semadb_tpu`` import. A subprocess with both blocked
imports every module of the port and runs a tiny slice on ``cpu``. The host
modules the port keeps its own copies of (``models/``, ``store/``,
``utils/{compare,grow,itemcache}.py``, ``index/{inverted,text}.py``,
``csrc/kvstore.cpp``) stay the same as the JAX
package's originals, apart from their imports and the store's native build;
so do the definitions it copies from ``utils/pipeline.py`` (all but the
readback), ``tools/datasets.py`` (the host generator and ground truth) and
``vectorstore/kmeans.py`` (``_group_rows``, host numpy).
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "semadb_tpu_torch")
JAX_PKG = os.path.join(ROOT, "semadb_tpu")


def _port_modules():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _allowed(name):
    return not (
        name == "jax" or name.startswith(("jax.", "jaxlib"))
        or name == "semadb_tpu" or name.startswith("semadb_tpu.")
    )


@pytest.mark.parametrize(
    "path", sorted(_port_modules()) + [os.path.join(ROOT, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, PKG) if p.startswith(PKG) else os.path.basename(p),
)
def test_port_module_imports(path):
    bad = [n for n in _imports(path) if not _allowed(n)]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


SLICE = r"""
import sys, tempfile
sys.modules["jax"] = None  # any import of jax now raises
sys.modules["semadb_tpu"] = None  # and of the JAX package
import pkgutil, importlib
import numpy as np, torch
import semadb_tpu_torch
for m in pkgutil.walk_packages(semadb_tpu_torch.__path__, "semadb_tpu_torch."):
    importlib.import_module(m.name)
from semadb_tpu_torch.models import Collection, IndexSchema, Point, SearchRequest, UserPlan
from semadb_tpu_torch.cluster.node import ClusterNode, ClusterNodeConfig
schema = {"v": {"type": "vectorFlat", "vectorFlat": {"vectorSize": 64, "distanceMetric": "cosine",
          "quantizer": {"type": "binary", "binary": {"distanceMetric": "hamming", "threshold": 0.0}}}}}
node = ClusterNode(ClusterNodeConfig(root_dir=tempfile.mkdtemp(), rpc_port=0), torch.device("cpu"))
node.serve()
col = Collection(user_id="u", id="c", index_schema=IndexSchema.from_dict(schema), user_plan=UserPlan())
node.create_collection(col)
col = node.get_collection("u", "c")
vecs = np.random.default_rng(0).standard_normal((50, 64)).astype(np.float32)
import uuid
assert node.insert_points(col, [Point.from_map({"v": v.tolist()}, uuid.uuid4()) for v in vecs]) == []
sr = SearchRequest.from_dict({"query": {"property": "v", "vectorFlat": {"vector": vecs[3].tolist(), "operator": "near", "limit": 5}}})
docs = node.search_points_batch_wire(col, [sr])[0]
assert len(docs) == 5 and docs[0]["_distance"] == 0.0, docs
node.close()
loaded = [m for m in sys.modules if m.startswith(("jax", "semadb_tpu.")) and sys.modules[m] is not None]
assert not loaded, loaded
print("OK")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SLICE], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("OK"), proc.stdout + proc.stderr


def _copies():
    for sub in ("models", "store"):
        for f in sorted(os.listdir(os.path.join(JAX_PKG, sub))):
            if f.endswith(".py") and (sub, f) != ("store", "native.py"):
                yield f"{sub}/{f}"
    yield "utils/compare.py"
    yield "utils/grow.py"
    yield "utils/itemcache.py"
    yield "index/inverted.py"
    yield "index/text.py"


class _Normalize(ast.NodeTransformer):
    """Name the JAX package where the copy names the port in an import."""

    @staticmethod
    def _name(name):
        return "semadb_tpu" + name[len("semadb_tpu_torch"):] if name.startswith("semadb_tpu_torch") else name

    def visit_Import(self, node):
        for a in node.names:
            a.name = self._name(a.name)
        return node

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = self._name(node.module)
        return node


def _ast(path, normalize=False):
    tree = ast.parse(open(path).read(), path)
    return ast.dump(_Normalize().visit(tree) if normalize else tree)


@pytest.mark.parametrize("rel", list(_copies()))
def test_copied_module_matches_original(rel):
    """Each copy has the original's AST once its imports name ``semadb_tpu``."""
    assert _ast(os.path.join(PKG, rel), normalize=True) == _ast(os.path.join(JAX_PKG, rel))


def _top_defs(path, names=None, drop=()):
    """{name: AST dump} of the module's top-level functions and classes
    (those in ``names``, or all), imports normalized, leaving out the class
    members named in ``drop``."""
    tree = _Normalize().visit(ast.parse(open(path).read(), path))
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and (names is None or node.name in names):
            if isinstance(node, ast.ClassDef):
                node.body = [n for n in node.body if getattr(n, "name", None) not in drop]
            out[node.name] = ast.dump(node)
    return out


# (module, the definitions copied (None: all), members that differ on purpose)
PARTIAL_COPIES = [
    # AsyncDispatcher._materialise reads tensors back with .cpu() where the
    # original maps jax.tree over np.asarray
    ("utils/pipeline.py", None, ("_materialise",)),
    ("tools/datasets.py", ("AnnDataset", "embedding_like", "compute_ground_truth"), ()),
    ("vectorstore/kmeans.py", ("_group_rows",), ()),
]


@pytest.mark.parametrize("rel,names,drop", PARTIAL_COPIES, ids=[c[0] for c in PARTIAL_COPIES])
def test_copied_definitions_match_original(rel, names, drop):
    """The definitions the port copies from a module have the original's AST."""
    port = _top_defs(os.path.join(PKG, rel), names, drop)
    orig = _top_defs(os.path.join(JAX_PKG, rel), names, drop)
    assert set(port) == set(orig) == (set(names) if names else set(orig))
    for name in orig:
        assert port[name] == orig[name], f"{rel}: {name} differs from the original"


def test_every_model_and_store_module_is_copied():
    for sub in ("models", "store"):
        want = {f for f in os.listdir(os.path.join(JAX_PKG, sub)) if f.endswith(".py")}
        have = {f for f in os.listdir(os.path.join(PKG, sub)) if f.endswith(".py")}
        assert have == want, sub


def test_kvstore_source_is_a_byte_copy():
    with open(os.path.join(ROOT, "native", "kvstore.cpp"), "rb") as a, \
            open(os.path.join(PKG, "csrc", "kvstore.cpp"), "rb") as b:
        assert a.read() == b.read()
