"""Launchers: the HAMLET service command line."""
