"""Entry points of the LM stack (``serve``, ``train``) and the pod-scale
tools (``dryrun`` over the ``cost`` counter, ``roofline``, ``mesh``)."""
