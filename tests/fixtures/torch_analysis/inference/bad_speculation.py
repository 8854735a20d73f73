"""Known-bad fixture for the speculation rule: the verify dispatch
must stay one captured graph, built once.

Both findings model real regressions: (1) capturing a graph inside the
propose/verify path (a per-step capture stall hidden from the
loop-based recompile rule — the function is called every step but is
not lexically inside a loop), and (2) building a verify graph off the
build/prewarm path, so each step captures anew and allocates new
static buffers.
"""
import torch


class _VerifyCall:
    def __init__(self, engine):
        self.engine = engine


def _propose_and_verify(drafts):
    # BAD: a fresh graph per verify call.
    graph = torch.cuda.CUDAGraph()
    return graph, drafts


def step(engine, drafts):
    # BAD: a verify graph per step, off the build/prewarm path.
    return _VerifyCall(engine)(drafts)


def _new_verify_call(engine):
    return _VerifyCall(engine)        # the build path: clean
