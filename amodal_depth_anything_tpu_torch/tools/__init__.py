"""Command-line tools of the port that are no part of its library surface."""
