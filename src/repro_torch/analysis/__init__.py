"""Cost models of the port on the card (Hopper launch and block plans)."""
