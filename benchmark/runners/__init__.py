"""Runners: one general generator per entry of the port; a traffic mix's
``runner`` key names the module."""
