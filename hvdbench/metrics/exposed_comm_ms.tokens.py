"""exposed_comm_ms.tokens: device ms a step in which NCCL's collective
kernels ran and no other kernel or copy did (``trace.exposed``, a copy of
``ops/exchange.py::exposed_comm_from_spans``'s interval arithmetic): the
gradient exchange not hidden behind backward. Nothing to read where no
collective kernel ran (one rank). Moves ``tokens_per_s_per_gpu``."""

from hvdbench import trace


def read(t):
    comm = [(s, d) for n, s, d in t.events if trace.is_comm(n)]
    if t.unit != "tokens" or not comm:
        return None
    compute = [(s, d) for n, s, d in t.events if not trace.is_comm(n)]
    return t.per_step_ms(trace.exposed(comm, compute))
