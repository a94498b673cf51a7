"""The port's sharding tier (``deeplearning4j_tpu_torch/analysis/
sharding.py``, SH01 and SH02).

The axis registry is parsed from the port's ``parallel/mesh.py`` and
equals its ``AXES``.  SH01 follows an axis name from a mesh's
construction through the ``with mesh:`` blocks the collectives of
``parallel/collectives.py`` resolve against (innermost first, and one
module-internal call level at a time); an axis arriving through a mesh
it cannot resolve keeps it silent.  SH02 checks ``P``/``PartitionSpec``
literals against the registry.
"""

import pytest

from deeplearning4j_tpu_torch.analysis import sharding as ts
from deeplearning4j_tpu_torch.analysis.core import all_rules
from deeplearning4j_tpu_torch.analysis.jitinfo import ModuleInfo
from deeplearning4j_tpu_torch.parallel import mesh as tmesh

HEAD = '''
from deeplearning4j_tpu_torch.parallel import collectives as clv
from deeplearning4j_tpu_torch.parallel.collectives import psum
from deeplearning4j_tpu_torch.parallel.mesh import (DP, TP, SP, Mesh,
    MeshSpec, P, PartitionSpec, local_mesh, make_mesh, elastic_mesh)
'''


def _lines(rule, body, path="deeplearning4j_tpu_torch/parallel/x.py"):
    src = HEAD + body.lstrip("\n")
    module = ModuleInfo(path, src)
    first = len(HEAD.splitlines())
    return sorted(f.line - first for f in all_rules()[rule].check(module))


def test_the_registry_is_the_port_mesh_table():
    assert ts.axis_registry() == frozenset(tmesh.AXES)
    assert ts.axis_constants() == {"DP": tmesh.DP, "TP": tmesh.TP,
                                   "PP": tmesh.PP, "SP": tmesh.SP,
                                   "EP": tmesh.EP}


def test_the_registry_hook_replaces_and_restores():
    ts.set_axis_registry(["dp", "xp"])
    try:
        assert ts.axis_registry() == {"dp", "xp"}
        assert _lines("SH02", "s = P('xp')\n") == []
    finally:
        ts.set_axis_registry(None)
    assert ts.axis_registry() == frozenset(tmesh.AXES)
    assert _lines("SH02", "s = P('xp')\n") == [1]


SH01_CASES = {
    "local mesh binds dp only": ('''
def step(x):
    mesh = local_mesh()
    with mesh:
        return clv.psum(x, "tp")
''', [4]),
    "make_mesh binds every axis": ('''
def step(x):
    with make_mesh(MeshSpec(dp=2, tp=2)):
        return clv.psum(x, TP) + psum(x, "dp")
''', []),
    "a helper inherits its caller's mesh": ('''
def helper(x):
    return clv.all_gather(x, TP, tiled=True)

def run(x):
    mesh = elastic_mesh([0, 1])
    with mesh:
        return helper(x)
''', [2]),
    "the innermost mesh decides": ('''
def step(x):
    with make_mesh():
        with local_mesh():
            return clv.reduce_scatter(x, "tp")
''', [4]),
    "a literal Mesh's axes": ('''
def step(x, devs):
    m = Mesh(devs, ("dp", "sp"))
    with m:
        y = clv.ppermute(x, SP, [(0, 1), (1, 0)])
        return clv.axis_index("tp") + y
''', [5]),
    "an unresolvable mesh is silent": ('''
class T:
    def step(self, x):
        with self.mesh:
            return clv.psum(x, "tp")
''', []),
    "a mesh's own axis_index is not a collective": ('''
def step(x):
    mesh = local_mesh()
    with mesh:
        return mesh.axis_index("tp")
''', []),
    "an axis parameter is silent": ('''
def reduce(x, axis):
    with local_mesh():
        return clv.pmean(x, axis)
''', []),
}


@pytest.mark.parametrize("name", sorted(SH01_CASES))
def test_sh01(name):
    body, want = SH01_CASES[name]
    assert _lines("SH01", body) == want


SH02_CASES = {
    "registry axes": ("a = P(DP, None)\nb = P(('dp', 'tp'))\nc = P()\n", []),
    "a typo": ("a = P('dpx', None)\n", [1]),
    "PartitionSpec spelled out": ("a = PartitionSpec(None, 'model')\n", [1]),
    "a typo in a tuple entry": ("a = P(('dp', 'tpp'))\n", [1]),
}


@pytest.mark.parametrize("name", sorted(SH02_CASES))
def test_sh02(name):
    body, want = SH02_CASES[name]
    assert _lines("SH02", body) == want


def test_sh01_message_names_the_axis_and_the_bound_set():
    src = HEAD + SH01_CASES["local mesh binds dp only"][0]
    (f,) = all_rules()["SH01"].check(ModuleInfo("x.py", src))
    assert "'tp'" in f.message and "['dp']" in f.message
    assert "identity" in f.message
