"""Host utilities of the port (LaTeX formatting for :mod:`..core`, and
the signal helpers of :mod:`.signal`)."""
