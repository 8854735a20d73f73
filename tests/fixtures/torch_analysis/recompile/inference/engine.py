"""Known-bad: a capture reachable from a hot entry point in a hot
module (path mirrors inference/engine.py), without an annotation; the
annotated one-shot capture beside it is suppressed."""
import torch


class Engine:
    def step(self):  # skytpu: hot-entry
        self._graph = self._build()
        self._warm = self._build_annotated()
        return self._graph

    def _build(self):
        graph = torch.cuda.CUDAGraph()   # BAD: a capture per step
        with torch.cuda.graph(graph):    # BAD: and its capture
            pass
        return graph

    def _build_annotated(self):
        # skytpu: allow-recompile(fixture counterpart of the engine's one-shot capture)
        return torch.cuda.CUDAGraph()
