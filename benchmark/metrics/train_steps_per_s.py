"""train_steps_per_s: training steps completed in the window over the
window, by the host clock (the window ends with a synchronise)."""


def read(run):
    if run.traffic["entry"] != "fit" or not run.window_s:
        return None
    return run.units / run.window_s
