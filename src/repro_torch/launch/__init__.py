"""Entry points of the port: the evolution command (``evolve``) and the
serving loop of model land (``serve``, ``steps``)."""
