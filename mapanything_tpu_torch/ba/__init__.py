"""Bundle adjustment of the port. So far the closed-form head of the global alignment
(``global_alignment``); the solver, tracks and tracker are ROADMAP section 1, item 4."""
