"""Model and deployment configurations of the port."""
