"""Sliding-window triangle counting over a generated edge stream, on the
PyTorch port (the card unless ``--device cpu``).

The paper's "dynamically generated" regime with DELETIONS: edges arrive in
epochs, only the most recent ``WINDOW`` epochs count, and the expired past
is dropped by rotating a ring of epoch bitsets — one slot clear per slide,
no per-edge deletes (docs/STREAMING.md §5). Every window's count is
asserted against a from-scratch recount oracle over the live edges.

    PYTHONPATH=src python examples/torch_windowed_stream.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import TriangleCounter
from repro_torch.core import streaming

N_NODES = 200
WINDOW = 4       # epochs the window covers
N_EPOCHS = 12    # epochs the stream runs for
EDGES_PER_EPOCH = 600
BLOCK = 200      # divides the epoch, so the mid-epoch peek below sees
                 # every edge ingested (nothing left in the BlockBuffer)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

rng = np.random.default_rng(0)
epoch_edges = [rng.integers(0, N_NODES, size=(EDGES_PER_EPOCH, 2)).astype(np.int32)
               for _ in range(N_EPOCHS)]


def recount_oracle(upto: int) -> int:
    """Brute-force recount of the window ending at epoch ``upto``: an edge
    is live iff its first arrival (while not already live) is within the
    last WINDOW epochs — the window-semantics contract of docs/STREAMING.md."""
    arrival = {}
    for t in range(upto + 1):
        for u, v in epoch_edges[t]:
            u, v = int(u), int(v)
            if u == v:
                continue
            e = (min(u, v), max(u, v))
            if e in arrival and arrival[e] > t - WINDOW:
                continue
            arrival[e] = t
    live = {e for e, a in arrival.items() if a > upto - WINDOW}
    adj = {i: set() for i in range(N_NODES)}
    for u, v in live:
        adj[u].add(v)
        adj[v].add(u)
    return sum(len(adj[u] & adj[v]) for u, v in live) // 3


# Drive one windowed session by hand: feed -> advance -> ... -> finalize.
counter = TriangleCounter(device=args.device)
session = counter.open_stream(N_NODES, window=WINDOW, block_size=BLOCK)
print(f"windowed session: n={N_NODES} window={WINDOW} epochs "
      f"(state: {session.state_bytes} B = {WINDOW} epoch bitsets)")

traces_before = streaming.ingest_trace_count()
for t, edges in enumerate(epoch_edges):
    if t:
        session.advance()  # slide: ONE epoch-slot clear, nothing re-ingested
    session.feed(edges)
    # peek at the live ring mid-stream (the session owns its state dict)
    live_now = int(streaming.window_count(session.state))
    want_now = recount_oracle(t)
    marker = "==" if live_now == want_now else "!!"
    print(f"  epoch {t:2d}: window count {live_now:4d} {marker} recount {want_now:4d}")
    assert live_now == want_now, (live_now, want_now)

result = session.finalize()
assert result.item() == recount_oracle(N_EPOCHS - 1)
print(f"final window ({max(0, N_EPOCHS - WINDOW)}..{N_EPOCHS - 1}): "
      f"{result.item()} triangles == recount oracle")
print(f"ingest traces for all {N_EPOCHS} epochs: "
      f"{streaming.ingest_trace_count() - traces_before} "
      f"(epoch advances never retrace)")

# The one-call wrapper, same stream, same answer.
res2 = counter.count_windowed(
    N_NODES, ([e] for e in epoch_edges), window=WINDOW, block_size=BLOCK)
assert res2.item() == result.item()
print(f"count_windowed wrapper: {res2.item()} "
      f"[{res2.stats['n_blocks']} blocks, "
      f"{res2.stats['epochs_advanced']} slides, plan: {res2.plan.reason}]")
