"""Launchers: the HAMLET service command line, the figures' configurations,
and the LM substrate's serving and training launchers."""
