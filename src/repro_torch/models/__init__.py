"""Models of the port: the dense GQA decoder (``transformer``) behind
``api.build_model``."""
