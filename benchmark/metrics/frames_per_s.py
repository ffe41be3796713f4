"""frames_per_s: frames on the host over the window, by the host clock."""


def read(run):
    if run.traffic["entry"] != "serve" or not run.window_s:
        return None
    return run.frames / run.window_s
