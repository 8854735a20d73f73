"""Known-bad: every device->host sync form the hot-loop-sync rule
knows, reachable from a hot entry point."""
import numpy as np
import torch


def hot_loop(state, mask, event, stream):  # skytpu: hot-entry
    out = helper_one(state)            # sync two calls away: still flagged
    a = state.item()                   # BAD: .item()
    b = state.tolist()                 # BAD: .tolist()
    c = state.cpu()                    # BAD: .cpu()
    d = state.numpy()                  # BAD: .numpy()
    e = state.to('cpu')                # BAD: .to('cpu')
    f = state.to(device='cpu')         # BAD: .to(device='cpu')
    torch.cuda.synchronize()           # BAD: torch.cuda.synchronize()
    event.synchronize()                # BAD: Event.synchronize()
    g = np.asarray(torch.sigmoid(state))   # BAD: np.asarray of a tensor
    h = float(torch.mean(state))       # BAD: float() on a tensor
    i = int(torch.argmax(state))       # BAD: int() on a tensor
    j = bool(torch.isnan(state).any())     # BAD: bool() on a tensor
    k = state.nonzero()                # BAD: .nonzero()
    m = torch.nonzero(state)           # BAD: torch.nonzero
    n = torch.unique(state)            # BAD: torch.unique
    o = torch.masked_select(state, mask)   # BAD: torch.masked_select
    if mask.any():                     # BAD: .any() as an if test
        pass
    while mask.all():                  # BAD: .all() as a while test
        break
    p = torch.tensor([1, 2], device=state.device)  # BAD: blocking upload
    with torch.cuda.graph(stream):
        q = state.item()               # captured: raises at capture, not flagged
    return out, a, b, c, d, e, f, g, h, i, j, k, m, n, o, p, q


def helper_one(state):
    return helper_two(state)


def helper_two(state):
    return state.cpu()                 # BAD: two hops from the entry


def unreachable_helper(state):
    # Not reachable from any hot entry: must NOT be flagged.
    return state.cpu()


class Call:
    def _capture(self, state):
        # Runs only while a CUDA graph is captured: not flagged.
        return state.item()
