"""Process-group helpers of the port (the counterpart of the reference's
``parallel/``).  Import the submodules directly."""
