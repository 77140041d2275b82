"""Model configs, parameter skeletons and the dense serving path
(``config``, ``param``, ``layers``, ``attention``, ``kvcache``,
``transformer``, ``api``)."""
