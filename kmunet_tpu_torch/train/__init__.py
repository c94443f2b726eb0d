"""Training of the port: schedule, optimizer and the train step."""
