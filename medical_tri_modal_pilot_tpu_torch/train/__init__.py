"""Train and eval steps, schedules, checkpoints and metrics of the port."""
