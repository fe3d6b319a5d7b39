"""The general generators that drive the port, one a kind of traffic."""
