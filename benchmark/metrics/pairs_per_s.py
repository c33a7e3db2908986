"""pairs_per_s: correct maps completed in the window over the window's
seconds, all clients together (harness clock)."""


def read(obs):
    if obs.window_s <= 0:
        return None
    return len(obs.good) / obs.window_s
