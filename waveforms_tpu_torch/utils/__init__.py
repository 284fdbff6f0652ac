"""Host utilities of the port (LaTeX formatting for :mod:`..core`)."""
