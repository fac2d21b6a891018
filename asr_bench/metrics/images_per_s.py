"""Images whose masks ``serve`` wrote, over the window: from the first image
handed to the timed call to the last completion (host clock)."""


def read(run):
    return run.images / run.window_s if run.window_s > 0 else None
