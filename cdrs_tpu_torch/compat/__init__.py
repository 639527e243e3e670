"""The reference user's call signatures on the port (``reference_api``) and the
legacy object-at-a-time planners the planner bench times against
(``reference_planners``)."""
