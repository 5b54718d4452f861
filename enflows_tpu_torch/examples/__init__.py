"""Example scripts of the port, counterparts of the repository's
``examples/`` (each runs on the card unless asked for the CPU)."""
