"""Training: the train state, the accumulating step, the device eval
protocol, checkpoints and the `fit` / `evaluate` loop."""
