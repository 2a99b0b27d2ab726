"""Helpers of the port: the environment record and the switch that the
command-line tools throw at start (`env`), PNG files without PIL (`png`),
depth colours without matplotlib (`color_depth`)."""
