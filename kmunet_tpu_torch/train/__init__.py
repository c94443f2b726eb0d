"""Training of the port: schedules, optimizers, checkpoints and the engine (the train step and the loop)."""
