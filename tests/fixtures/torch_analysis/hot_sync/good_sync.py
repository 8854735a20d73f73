"""Known-good: the one intentional sync is annotated with a reason."""
import torch


def hot_loop(state):  # skytpu: hot-entry
    # skytpu: allow-sync(the one fetch per step - fixture counterpart of the engine contract)
    out = state.cpu()
    return host_math([1, 2, 3]), out, torch.as_tensor([1, 2])


def host_math(values):
    return sum(values)               # no device involvement: clean
