"""Device rule, image helpers, weight conversion, kernel builder."""
