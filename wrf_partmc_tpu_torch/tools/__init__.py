"""Input tools of the port: ICs, BCs, emissions, wrfinput, mozbc and the
urban-plume box scenario."""
