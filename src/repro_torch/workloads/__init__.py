"""The paper's MI workload suite (Table 2): ``suite.SUITE``."""
