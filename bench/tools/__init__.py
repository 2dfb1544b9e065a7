"""Scripts that set the benchmark's data: the frozen profile and the
readings the check's limits come from. The benchmark's runs use none of
them."""
