"""Mean host span of a `BassRouter.route` call in the window."""


def read(run):
    return run.spans.mean_ms("route", *run.window)
