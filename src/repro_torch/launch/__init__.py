"""Launchers of the port: ``launch.train`` (the training CLI, with its
watchdog) and ``launch.dist`` (a process group from the environment)."""
