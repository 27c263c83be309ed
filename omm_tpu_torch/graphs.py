"""Each batch's capacity chain as one captured CUDA graph.

The JAX package runs a batch at cached capacities as one jit dispatch
(`_spec_chain`); the port's counterpart on a card is a CUDA graph of
`twophase.spec_chain`, replayed for every later batch of the same shape.
A graph reads static input buffers (the batch's UV table, winding and,
for a partial batch, its active mask), the texture's cached planes,
and writes one payload buffer, all of which its entry holds.

Graphs are cached per texture and device beside the planes they read
(`planes.tex_cache`, key "graphs"), keyed by everything the chain is
built from but the capacities; an entry whose capacities changed is
dropped and captured again.  The graphs of one texture and device share
one memory pool: their replays are ordered on the device's current
stream, one at a time, and each entry keeps its inputs and payload
alive.

The first call for a key warms the chain up on a side stream (its result
is that batch's), then captures it; later calls copy their inputs in,
replay, and copy the payload out, under the texture's graph lock, since
mesh slots on one card are threads on one stream.  The exact kernel's
launches inside a graph count at each replay.  A failed capture or
replay raises.
"""
from __future__ import annotations

import threading

import torch

from . import routes
from .kernels import counts
from .planes import tex_cache
from .spans import span

#: one capture at a time in the process (a capture syncs the device)
_CAPTURE_LOCK = threading.Lock()
#: makes the creation of a texture's graph state one step for threads
_STATE_LOCK = threading.Lock()


class _Entry:
    """One captured chain: its capacities, graph, static inputs, payload
    and the kernel launches each replay makes, by name."""

    __slots__ = ("caps", "graph", "inputs", "payload", "launches")

    def __init__(self, caps, graph, inputs, payload, launches):
        self.caps = caps
        self.graph = graph
        self.inputs = inputs
        self.payload = payload
        self.launches = launches


class _State:
    """A texture's graphs on one card, their memory pool, the side stream
    of their warm-ups and captures, and the lock that orders each
    copy-in, replay and copy-out (and each capture) against the others:
    a graph's replay may reuse memory of another graph's payload."""

    def __init__(self, device):
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.lock = threading.Lock()


def _state(texture, device) -> _State:
    c = tex_cache(texture, device)
    with _STATE_LOCK:
        st = c.get("graphs")
        if st is None:
            st = c["graphs"] = _State(device)
        return st


def _to_host(payload):
    """Start the payload's copy into pinned host memory on the current
    stream: (host tensor, event recorded after the copy)."""
    dst = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
    routes.count("pinned_alloc")
    dst.copy_(payload, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return dst, ev


def _copy_in(static, host_inputs):
    routes.count("pinned_alloc", len(host_inputs))
    for dst, src in zip(static, host_inputs):
        dst.copy_(src.pin_memory(), non_blocking=True)


def run(texture, device, key, caps, host_inputs, chain):
    """Enqueue chain(*inputs) on a card through the graph cached under
    `key`: host_inputs are CPU tensors, copied into the graph's static
    inputs.  Returns (pinned host payload, CUDA event): the payload is
    there once the event has completed."""
    device = torch.device(device)
    with torch.cuda.device(device), span("omm.spec"):
        st = _state(texture, device)
        with st.lock:
            entry = st.graphs.get(key)
            if entry is None or entry.caps != caps:
                st.graphs.pop(key, None)
                with _CAPTURE_LOCK:
                    return _capture(st, key, caps, host_inputs, chain,
                                    device)
            _copy_in(entry.inputs, host_inputs)
            entry.graph.replay()
            counts.add(entry.launches)
            routes.count("graph_replay")
            return _to_host(entry.payload)


def _capture(st, key, caps, host_inputs, chain, device):
    """Warm the chain up on the side stream (this batch's result), then
    capture it into a new entry."""
    static = [torch.empty(h.shape, dtype=h.dtype, device=device)
              for h in host_inputs]
    _copy_in(static, host_inputs)
    cur = torch.cuda.current_stream(device)
    st.stream.wait_stream(cur)
    with torch.cuda.stream(st.stream):
        out = chain(*static)
    cur.wait_stream(st.stream)
    out.record_stream(cur)
    result = _to_host(out)

    graph = torch.cuda.CUDAGraph()
    counts.captured()
    with torch.cuda.graph(graph, pool=st.pool, stream=st.stream,
                          capture_error_mode="thread_local"):
        payload = chain(*static)
    st.graphs[key] = _Entry(caps, graph, static, payload,
                            counts.captured())
    routes.count("graph_capture")
    return result
