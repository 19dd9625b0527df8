"""Parameter bridges into the port."""
