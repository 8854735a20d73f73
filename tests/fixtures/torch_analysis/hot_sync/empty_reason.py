"""Known-bad: an allow-sync annotation WITHOUT a reason does not
suppress — the reason is the point."""


def hot_loop(state):  # skytpu: hot-entry
    # skytpu: allow-sync()
    return state.cpu()
