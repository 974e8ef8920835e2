"""Static verification of the port's serving stack over ``torch.export``
graphs (the counterpart of the JAX package's ``analysis``, which works
over jaxprs and compiled HLO).

The paper's two load-bearing guarantees are *structural*, so they are
checked on captured graphs rather than sampled outputs:

* ``analysis.signs``: abstract interpretation over exported FX graphs
  with a sign/interval domain, the hand-written kernels inlined through
  their plain versions.  Proves the corrector ``s*sigma(v)`` is
  elementwise nonnegative and hence ``fhat <= u`` for every registered
  arch and every ``sigma`` kind, or emits the offending producer chain
  (node, aten target, ``file:line``) as a counterexample.
* ``analysis.graph``: per-node rules over exported graphs:
  ``collective-free``, ``no-host-transfer``, ``no-dynamic-shapes``, each
  with an explicit allowlist.  ``serving/mesh.py``'s op recorder takes
  its list of collective namespaces from here.
* ``analysis.recompile``: a call-signature tracker ``MonitorSession``
  arms to assert each serving path keeps its signatures across a churn
  episode (the port runs eagerly: a signature is what a jit would
  compile and a CUDA graph would capture).
* ``analysis.rules``: the rule registry and report that ``python -m
  repro_torch.analysis`` prints, with a mutation self-test that seeds
  violations and asserts each rule fires.
"""
from repro_torch.analysis.signs import (  # noqa: F401
    Interval, SignAnalysis, SignCertificate, analyze_graph,
    verify_catchup, verify_forward,
)
from repro_torch.analysis.graph import (  # noqa: F401
    GraphHit, assert_collective_free, collective_nodes,
    dynamic_shape_nodes, host_transfer_nodes, monitor_path_graphs,
)
from repro_torch.analysis.recompile import (  # noqa: F401
    RecompileError, RecompileGuard,
)
