"""End-to-end amodal-depth inference."""
