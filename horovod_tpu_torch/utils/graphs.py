"""A function captured once as a CUDA graph and replayed.

The capture core that ``parallel/spmd.py`` (the training step) and
``serving/engine.py`` (the engine's forwards) share:

1. :meth:`Graph.eager` runs the function once eagerly on a side stream of
   the graph's own: every lazy initialisation a capture cannot do (cuBLAS
   handles, a kernel's launch table or barrier words, optimizer state)
   happens there, on the stream the capture then uses;
2. :meth:`Graph.capture` records the function into one
   ``torch.cuda.CUDAGraph`` on that stream
   (``capture_error_mode="thread_local"``), in a memory pool the caller may
   share between its graphs. The tensors the function reads are the static
   inputs: the caller writes new values into them before each replay. A
   kernel wrapper called under the capture launches nothing and records
   its launch (``ops/launches.py``); a capture that fails raises
   :class:`HorovodError` with the caller's rules, and nothing falls back to
   eager;
3. :meth:`Graph.replay` runs the graph, counts the recorded launches, and
   returns the outputs cloned (the next replay overwrites the static ones)
   or, for a caller that copies them out at once, the static ones.

A capture records without running: the eager call and the capture together
advance the state once, as one call would.
"""

from __future__ import annotations

import contextlib
import gc

import torch
import torch.utils._pytree as pytree

from horovod_tpu_torch.core.state import HorovodError
from horovod_tpu_torch.ops import launches as _launches


class Graph:
    """One function's CUDA graph, its side stream and its static outputs.
    ``stream``: the side stream (made at the first :meth:`eager` when
    None); ``graph`` is None until :meth:`capture`."""

    def __init__(self, stream: torch.cuda.Stream | None = None) -> None:
        self.stream = stream
        self.graph: torch.cuda.CUDAGraph | None = None
        self.launches: list = []  # kernel launches a replay makes
        self.static_out: list = []
        self.out_spec = None

    def eager(self, device, fn, *args):
        """``fn(*args)`` run eagerly on the side stream, ordered after the
        current stream's work and before its later work."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        cur = torch.cuda.current_stream(device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn, *args, pool=None, within=None, what: str,
                rules: str):
        """Record ``fn(*args)`` into the graph, in ``pool`` (a
        ``graph_pool_handle`` or another graph's ``pool()``; None for a
        new one), with ``within`` (a context manager) entered inside the
        capture. Returns what ``within`` entered as. A failure raises
        :class:`HorovodError`: ``{what} could not be captured as a CUDA
        graph: {error}. {rules}``."""
        graph = torch.cuda.CUDAGraph()
        # No collection inside the capture: a finalizer freeing a tensor
        # could make a CUDA call a capture forbids. torch.cuda.graph
        # collects just before it begins.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _launches.recording() as launches, \
                    torch.cuda.graph(graph, pool=pool, stream=self.stream,
                                     capture_error_mode="thread_local"), \
                    (within or contextlib.nullcontext()) as entered:
                out = fn(*args)
        except HorovodError:
            raise
        except Exception as e:
            raise HorovodError(
                f"{what} could not be captured as a CUDA graph: {e}. "
                f"{rules}") from e
        finally:
            if collecting:
                gc.enable()
        self.static_out, self.out_spec = pytree.tree_flatten(out)
        self.graph = graph
        self.launches = launches
        return entered

    def replay(self, clone: bool = True):
        """Run the graph once on the current stream and count its launches;
        returns its outputs, cloned unless ``clone=False`` (then the static
        tensors, valid until the next replay of a graph of the pool)."""
        self.graph.replay()
        _launches.replayed(self.launches)
        out = self.static_out
        if clone:
            out = [t.clone() if isinstance(t, torch.Tensor) else t
                   for t in out]
        return pytree.tree_unflatten(out, self.out_spec)
