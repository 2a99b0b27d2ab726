"""Process-level helpers of the port: the environment record and the switch
that the command-line tools throw at start."""
