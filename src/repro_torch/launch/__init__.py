"""Entry points of the port's model land: the serving loop and its steps."""
