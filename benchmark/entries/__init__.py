"""The entries a traffic file can name: `serve` (batches rendered and
copied to the host, a closed loop) and `fit` (training steps back to
back). Each `run(run)` sets up, measures the window and returns the
numbers its check compares."""
