"""One generator and one configuration file per configuration."""
