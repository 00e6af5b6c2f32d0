"""Entry points of the LM stack (``serve``)."""
