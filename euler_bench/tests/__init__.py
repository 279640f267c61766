"""The benchmark's tests (CPU, and the card where marked ``cuda``)."""
