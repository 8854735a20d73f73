"""Known-bad: a CUDA-graph capture, a torch.compile and a kernel build
inside loops — a fresh graph / compiled callable / library per
iteration.

The while sits NESTED inside the for: its capture is visible from both
enclosing loops but must count as ONE finding (dedupe regression)."""
import torch
from torch.utils import cpp_extension


def serve_requests(requests_list, fn):
    results = []
    for req in requests_list:
        compiled = torch.compile(fn)     # BAD: recompiled per request
        results.append(compiled(req))
        while True:
            graph = torch.cuda.CUDAGraph()   # BAD: a new graph per pass
            results.append(graph)
            break
    return results


def build_all(sources):
    # BAD: a kernel build per source (a comprehension is a loop too).
    return [cpp_extension.load(name=s, sources=[s]) for s in sources]


def fine(fn, xs):
    compiled = torch.compile(fn)         # hoisted: compiled once — clean
    return [compiled(x) for x in xs]
