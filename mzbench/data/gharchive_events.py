"""GH Archive hourly event records of 2019: one JSON object a line, in the
archive's full event shape (``id``, ``type``, ``actor``, ``repo``,
``payload`` shaped by the type, ``public``, ``created_at``, and ``org`` on
some events), with creation times that rise as in an hourly file.

Each payload carries the objects that the archive's payloads of June 2019
carry, field for field: full user objects (18 fields, with their API and
HTML URLs), a pull request with its ``head`` and ``base``, each with its
user and its full repository object (owner, every URL template, counts,
license), ``_links``, issues, comments, review comments with their pull
request and diff hunk, releases, pushes of 1-20 commits.

The distributions are set here and listed under ``assumed`` in the
configuration.  The population (actors, organisations, repositories, their
metadata and popularity) is the archive's, drawn once from ``WORLD_SEED``;
the events are drawn from the run's seed: event types Zipf-skewed over the
public types with ``PushEvent`` first; actors and repositories
Zipf-skewed over those populations; text (commit messages, titles, bodies,
descriptions) Zipf-skewed over a vocabulary whose most common words are
``WORDS``; SHAs random hex.
"""

from __future__ import annotations

import datetime

import torch

from .. import fields as F

TYPES = ("PushEvent", "CreateEvent", "WatchEvent", "PullRequestEvent",
         "IssueCommentEvent", "IssuesEvent", "DeleteEvent", "ForkEvent",
         "PullRequestReviewCommentEvent", "ReleaseEvent", "GollumEvent",
         "MemberEvent", "CommitCommentEvent", "PublicEvent")
TYPE_THETA = 1.6
ACTORS, ACTOR_THETA = 1 << 17, 0.9
REPOS, REPO_THETA = 1 << 17, 1.0
ORGS, ORG_SHARE = 1 << 13, 0.2
VOCAB, WORD_THETA = 1 << 14, 1.0
COMMITS, COMMIT_THETA = 20, 2.0  # commits a push: 1-20, Zipf
DESC_WORDS = 12
START = datetime.datetime(2019, 6, 1)
EPOCH = datetime.datetime(2008, 1, 1)  # repository and issue dates from here
# Mean gap between events: two days at this gap hold the source file's
# 6,273,951,764 bytes at this generator's mean event size (2,395 bytes).
MEAN_GAP_S = 0.066
ROWS = 1 << 15  # records made a call, at most
# The population (actors, organisations, repositories and how popular each
# is) is the archive's, drawn once from this seed; the events are drawn
# from the run's.
WORLD_SEED = 20190601

SYLLABLES = ("ka", "lo", "mi", "ne", "ra", "to", "vi", "su", "de", "jo",
             "an", "el", "is", "or", "un", "bo", "ch", "da", "fe", "gu",
             "ha", "ja", "ke", "li", "ma", "no", "pa", "qu", "ri", "sa",
             "te", "wa", "xe", "yo", "za", "be", "ci", "do", "fu", "ge",
             "hi", "jo", "ku", "la", "me", "ni", "po", "ro", "si", "tu",
             "ve", "wi", "xi", "ya", "zo", "ar", "en", "in", "on", "us",
             "ex", "ax", "ol", "im")
WORDS = ("update", "fix", "add", "the", "readme", "to", "for", "and", "of",
         "in", "test", "bug", "remove", "use", "support", "merge", "branch",
         "master", "into", "from", "pull", "request", "version", "docs",
         "build", "config", "refactor", "code", "new", "file", "files",
         "change", "changes", "initial", "commit", "release", "api", "data",
         "error", "issue", "when", "with", "on", "a", "is", "not", "it",
         "page", "style", "css", "js", "index", "html", "script", "travis",
         "ci", "dependency", "bump", "package", "json", "lock", "yarn",
         "npm", "typo", "cleanup", "improve", "performance", "memory",
         "crash", "handle", "null", "check", "value", "default", "option",
         "user", "login", "auth", "token", "server", "client", "request",
         "response", "model", "view", "controller", "route", "router",
         "test", "tests", "unit", "integration", "lint", "format", "type",
         "types", "module", "import", "export", "function", "class",
         "method", "variable", "name", "rename", "move", "delete", "create",
         "list", "table", "column", "row", "query", "database", "migration",
         "schema", "field", "image", "icon", "logo", "link", "links", "url",
         "path", "dir", "folder", "script", "scripts", "setup", "install",
         "docker", "image", "deploy", "deployment", "prod", "dev", "local",
         "env", "variables", "secret", "key", "keys", "log", "logging",
         "debug", "warning", "message", "messages", "text", "string", "date",
         "time", "timezone", "locale", "translation", "i18n", "english",
         "support", "windows", "linux", "macos", "android", "ios", "mobile",
         "web", "app", "apps", "service", "services", "worker", "job",
         "queue", "cache", "redis", "sql", "mysql", "postgres", "mongo",
         "react", "vue", "angular", "node", "python", "java", "go", "rust",
         "kotlin", "swift", "ruby", "rails", "django", "flask", "spring",
         "webpack", "babel", "eslint", "prettier", "jest", "mocha", "gradle",
         "maven", "make", "cmake", "gcc", "clang", "compiler", "warnings",
         "release", "notes", "changelog", "license", "contributing", "guide",
         "example", "examples", "demo", "sample", "tutorial", "wip", "done",
         "todo", "minor", "major", "patch", "small", "big", "more", "less")
BRANCHES = ("master", "master", "master", "gh-pages", "develop", "dev",
            "patch-1", "feature/update", "fix/readme", "release/1.0")
DOMAINS = ("users.noreply.github.com", "gmail.com", "outlook.com",
           "example.org", "qq.com")
LANGUAGES = ("JavaScript", "Python", "Java", "TypeScript", "Go", "C++", "PHP",
             "Ruby", "C#", "C", "Shell", "HTML", "CSS", "Kotlin", "Swift",
             "Rust", "Jupyter Notebook", "Vue", "Dart", "Scala")
LICENSES = (
    '{"key":"mit","name":"MIT License","spdx_id":"MIT","url":'
    '"https://api.github.com/licenses/mit","node_id":"MDc6TGljZW5zZTEz"}',
    '{"key":"apache-2.0","name":"Apache License 2.0","spdx_id":"Apache-2.0",'
    '"url":"https://api.github.com/licenses/apache-2.0","node_id":'
    '"MDc6TGljZW5zZTI="}',
    '{"key":"gpl-3.0","name":"GNU General Public License v3.0","spdx_id":'
    '"GPL-3.0","url":"https://api.github.com/licenses/gpl-3.0","node_id":'
    '"MDc6TGljZW5zZTk="}',
    '{"key":"other","name":"Other","spdx_id":"NOASSERTION","url":null,'
    '"node_id":"MDc6TGljZW5zZTA="}',
    "null", "null", "null")
LABELS = ("bug\",\"color\":\"d73a4a", "enhancement\",\"color\":\"a2eeef",
          "question\",\"color\":\"d876e3",
          "documentation\",\"color\":\"0075ca",
          "duplicate\",\"color\":\"cfd3d7", "invalid\",\"color\":\"e4e669")
ASSOCIATIONS = ("NONE", "CONTRIBUTOR", "MEMBER", "OWNER", "COLLABORATOR")

API = "https://api.github.com"
USER = (
    '{"login":"${l}","id":${i},"node_id":"${n}","avatar_url":'
    '"https://avatars${k}.githubusercontent.com/u/${i}?v=4","gravatar_id":"",'
    '"url":"' + API + '/users/${l}","html_url":"https://github.com/${l}",'
    '"followers_url":"' + API + '/users/${l}/followers","following_url":'
    '"' + API + '/users/${l}/following{/other_user}","gists_url":'
    '"' + API + '/users/${l}/gists{/gist_id}","starred_url":'
    '"' + API + '/users/${l}/starred{/owner}{/repo}","subscriptions_url":'
    '"' + API + '/users/${l}/subscriptions","organizations_url":'
    '"' + API + '/users/${l}/orgs","repos_url":"' + API + '/users/${l}/repos",'
    '"events_url":"' + API + '/users/${l}/events{/privacy}",'
    '"received_events_url":"' + API + '/users/${l}/received_events",'
    '"type":"User","site_admin":false}')
R = API + "/repos/${f}"
REPO = (
    '{"id":${i},"node_id":"${n}","name":"${name}","full_name":"${f}",'
    '"private":false,"owner":${owner},"html_url":"https://github.com/${f}",'
    '"description":${desc},"fork":${fork},"url":"' + R + '","forks_url":'
    '"' + R + '/forks","keys_url":"' + R + '/keys{/key_id}",'
    '"collaborators_url":"' + R + '/collaborators{/collaborator}",'
    '"teams_url":"' + R + '/teams","hooks_url":"' + R + '/hooks",'
    '"issue_events_url":"' + R + '/issues/events{/number}","events_url":'
    '"' + R + '/events","assignees_url":"' + R + '/assignees{/user}",'
    '"branches_url":"' + R + '/branches{/branch}","tags_url":"' + R + '/tags",'
    '"blobs_url":"' + R + '/git/blobs{/sha}","git_tags_url":'
    '"' + R + '/git/tags{/sha}","git_refs_url":"' + R + '/git/refs{/sha}",'
    '"trees_url":"' + R + '/git/trees{/sha}","statuses_url":'
    '"' + R + '/statuses/{sha}","languages_url":"' + R + '/languages",'
    '"stargazers_url":"' + R + '/stargazers","contributors_url":'
    '"' + R + '/contributors","subscribers_url":"' + R + '/subscribers",'
    '"subscription_url":"' + R + '/subscription","commits_url":'
    '"' + R + '/commits{/sha}","git_commits_url":"' + R + '/git/commits{/sha}",'
    '"comments_url":"' + R + '/comments{/number}","issue_comment_url":'
    '"' + R + '/issues/comments{/number}","contents_url":'
    '"' + R + '/contents/{+path}","compare_url":'
    '"' + R + '/compare/{base}...{head}","merges_url":"' + R + '/merges",'
    '"archive_url":"' + R + '/{archive_format}{/ref}","downloads_url":'
    '"' + R + '/downloads","issues_url":"' + R + '/issues{/number}",'
    '"pulls_url":"' + R + '/pulls{/number}","milestones_url":'
    '"' + R + '/milestones{/number}","notifications_url":'
    '"' + R + '/notifications{?since,all,participating}","labels_url":'
    '"' + R + '/labels{/name}","releases_url":"' + R + '/releases{/id}",'
    '"deployments_url":"' + R + '/deployments","created_at":"${created}",'
    '"updated_at":"${updated}","pushed_at":"${pushed}","git_url":'
    '"git://github.com/${f}.git","ssh_url":"git@github.com:${f}.git",'
    '"clone_url":"https://github.com/${f}.git","svn_url":'
    '"https://github.com/${f}","homepage":null,"size":${size},'
    '"stargazers_count":${stars},"watchers_count":${stars},"language":'
    '${lang},"has_issues":true,"has_projects":true,"has_downloads":true,'
    '"has_wiki":true,"has_pages":false,"forks_count":${forks},'
    '"mirror_url":null,"archived":false,"disabled":false,'
    '"open_issues_count":${issues},"license":${license},"forks":${forks},'
    '"open_issues":${issues},"watchers":${stars},"default_branch":"master"}')
P = R + "/pulls/${num}"
PULL = (
    '{"url":"' + P + '","id":${id},"node_id":"${n}","html_url":'
    '"https://github.com/${f}/pull/${num}","diff_url":'
    '"https://github.com/${f}/pull/${num}.diff","patch_url":'
    '"https://github.com/${f}/pull/${num}.patch","issue_url":'
    '"' + R + '/issues/${num}","number":${num},"state":"${state}",'
    '"locked":false,"title":"${title}","user":${user},"body":"${body}",'
    '"created_at":"${opened}","updated_at":"${now}","closed_at":${closed},'
    '"merged_at":${merged_at},"merge_commit_sha":"${merge_sha}",'
    '"assignee":null,"assignees":[],"requested_reviewers":[],'
    '"requested_teams":[],"labels":[],"milestone":null,"commits_url":'
    '"' + P + '/commits","review_comments_url":"' + P + '/comments",'
    '"review_comment_url":"' + R + '/pulls/comments{/number}",'
    '"comments_url":"' + R + '/issues/${num}/comments","statuses_url":'
    '"' + R + '/statuses/${head_sha}","head":{"label":"${head_login}:'
    '${branch}","ref":"${branch}","sha":"${head_sha}","user":${head_user},'
    '"repo":${head_repo}},"base":{"label":"${base_login}:master","ref":'
    '"master","sha":"${base_sha}","user":${base_user},"repo":${base_repo}},'
    '"_links":{"self":{"href":"' + P + '"},"html":{"href":'
    '"https://github.com/${f}/pull/${num}"},"issue":{"href":'
    '"' + R + '/issues/${num}"},"comments":{"href":'
    '"' + R + '/issues/${num}/comments"},"review_comments":{"href":'
    '"' + P + '/comments"},"review_comment":{"href":'
    '"' + R + '/pulls/comments{/number}"},"commits":{"href":'
    '"' + P + '/commits"},"statuses":{"href":"' + R + '/statuses/${head_sha}"'
    '}},"author_association":"${assoc}","merged":${merged},"mergeable":null,'
    '"rebaseable":null,"mergeable_state":"unknown","merged_by":${merged_by},'
    '"comments":${comments},"review_comments":${reviews},'
    '"maintainer_can_modify":false,"commits":${commits},"additions":${adds},'
    '"deletions":${dels},"changed_files":${files}}')
ISSUE = (
    '{"url":"' + R + '/issues/${num}","repository_url":"' + R + '",'
    '"labels_url":"' + R + '/issues/${num}/labels{/name}","comments_url":'
    '"' + R + '/issues/${num}/comments","events_url":'
    '"' + R + '/issues/${num}/events","html_url":'
    '"https://github.com/${f}/issues/${num}","id":${id},"node_id":"${n}",'
    '"number":${num},"title":"${title}","user":${user},"labels":[${labels}],'
    '"state":"${state}","locked":false,"assignee":null,"assignees":[],'
    '"milestone":null,"comments":${comments},"created_at":"${opened}",'
    '"updated_at":"${now}","closed_at":${closed},"author_association":'
    '"${assoc}",${pr}"body":"${body}"}')
LABEL = ('{"id":${id},"node_id":"${n}","url":"' + R + '/labels/${name}",'
         '"name":"${label}","default":true}')
ISSUE_PR = ('"pull_request":{"url":"' + R + '/pulls/${num}","html_url":'
            '"https://github.com/${f}/pull/${num}","diff_url":'
            '"https://github.com/${f}/pull/${num}.diff","patch_url":'
            '"https://github.com/${f}/pull/${num}.patch"},')
COMMENT = (
    '{"url":"' + R + '/issues/comments/${id}","html_url":'
    '"https://github.com/${f}/issues/${num}#issuecomment-${id}",'
    '"issue_url":"' + R + '/issues/${num}","id":${id},"node_id":"${n}",'
    '"user":${user},"created_at":"${now}","updated_at":"${now}",'
    '"author_association":"${assoc}","body":"${body}"}')
REVIEW_COMMENT = (
    '{"url":"' + R + '/pulls/comments/${id}","pull_request_review_id":'
    '${review},"id":${id},"node_id":"${n}","diff_hunk":"@@ -${line},7 '
    '+${line},8 @@ ${h1}\\n ${h2}\\n+${h3}","path":"${path}","position":'
    '${pos},"original_position":${pos},"commit_id":"${sha}",'
    '"original_commit_id":"${sha}","user":${user},"body":"${body}",'
    '"created_at":"${now}","updated_at":"${now}","html_url":'
    '"https://github.com/${f}/pull/${num}#discussion_r${id}",'
    '"pull_request_url":"' + P + '","author_association":"${assoc}",'
    '"_links":{"self":{"href":"' + R + '/pulls/comments/${id}"},"html":'
    '{"href":"https://github.com/${f}/pull/${num}#discussion_r${id}"},'
    '"pull_request":{"href":"' + P + '"}}}')
COMMIT = ('{"sha":"${sha}","author":{"email":"${email}","name":"${name}"},'
          '"message":"${message}","distinct":true,"url":'
          '"' + R + '/commits/${sha}"}')
RELEASE = (
    '{"url":"' + R + '/releases/${id}","assets_url":'
    '"' + R + '/releases/${id}/assets","upload_url":'
    '"https://uploads.github.com/repos/${f}/releases/${id}/assets{?name,'
    'label}","html_url":"https://github.com/${f}/releases/tag/${tag}",'
    '"id":${id},"node_id":"${n}","tag_name":"${tag}","target_commitish":'
    '"master","name":"${title}","draft":false,"author":${user},'
    '"prerelease":false,"created_at":"${now}","published_at":"${now}",'
    '"assets":[],"tarball_url":"' + R + '/tarball/${tag}","zipball_url":'
    '"' + R + '/zipball/${tag}","body":"${body}"}')
COMMIT_COMMENT = (
    '{"url":"' + R + '/comments/${id}","html_url":'
    '"https://github.com/${f}/commit/${sha}#commitcomment-${id}","id":${id},'
    '"node_id":"${n}","user":${user},"position":null,"line":null,'
    '"path":null,"commit_id":"${sha}","created_at":"${now}","updated_at":'
    '"${now}","author_association":"${assoc}","body":"${body}"}')
HEAD = (
    '{"id":"${id}","type":"${type}","actor":{"id":${aid},"login":"${login}",'
    '"display_login":"${login}","gravatar_id":"","url":'
    '"' + API + '/users/${login}","avatar_url":'
    '"https://avatars.githubusercontent.com/u/${aid}?"},"repo":{"id":${rid},'
    '"name":"${f}","url":"' + R + '"},"payload":')
TAIL = '${payload},"public":true,"created_at":"${now}"${org}}\n'
ORG = (',"org":{"id":${i},"login":"${l}","gravatar_id":"","url":'
       '"' + API + '/orgs/${l}","avatar_url":'
       '"https://avatars.githubusercontent.com/u/${i}?"}')


class World:
    """Actors, organisations and repositories with their metadata and
    popularity orders, and the text vocabulary, drawn from ``gen``."""

    def __init__(self, gen, device):
        def randint(lo, hi, n):
            return torch.randint(lo, hi, (n,), generator=gen, device=device)

        syl = F.table(SYLLABLES, device)

        def coined(n, lo, hi):
            k = randint(lo, hi + 1, n)
            return F.join([F.keep(F.pick(syl, randint(0, len(SYLLABLES), n)),
                                  k > i) for i in range(hi)])

        def login(n):
            has_num = torch.rand(n, generator=gen, device=device) < 0.35
            return F.join([coined(n, 2, 4),
                           F.keep(F.digits(randint(0, 10000, n), 4),
                                  has_num)])

        words = F.table(WORDS, device)
        more = coined(VOCAB - len(WORDS), 2, 4)
        width = max(words[0].shape[1], more[0].shape[1])
        self.vocab = (torch.cat([
            torch.nn.functional.pad(words[0], (0, width - words[0].shape[1])),
            torch.nn.functional.pad(more[0], (0, width - more[0].shape[1]))]),
            torch.cat([words[1], more[1]]))
        self.actor_perm = torch.randperm(ACTORS, generator=gen, device=device)
        self.repo_perm = torch.randperm(REPOS, generator=gen, device=device)
        self.org_perm = torch.randperm(ORGS, generator=gen, device=device)
        self.actor_id = randint(1, 52_000_000, ACTORS)
        self.actor_login = login(ACTORS)
        self.org_id = randint(1, 52_000_000, ORGS)
        self.org_login = login(ORGS)
        self.repo_id = randint(1, 190_000_000, REPOS)
        self.repo_owner = F.zipf_items(gen, self.actor_perm, ACTOR_THETA,
                                       REPOS)
        sep = F.table(("-", "_", ".", ""), device)
        self.repo_name = F.join([
            F.pick(self.vocab, F.zipf_ranks(gen, len(WORDS), WORD_THETA,
                                            REPOS, device)),
            F.pick(sep, randint(0, 4, REPOS)),
            F.pick(self.vocab, randint(0, VOCAB, REPOS))])
        self.repo_desc = F.zipf_ranks(gen, VOCAB, WORD_THETA,
                                      REPOS * DESC_WORDS, device).reshape(
                                          REPOS, DESC_WORDS)
        self.repo_desc_n = randint(0, DESC_WORDS + 1, REPOS)
        self.repo_lang = F.zipf_ranks(gen, len(LANGUAGES) + 1, 1.0, REPOS,
                                      device)
        self.repo_license = randint(0, len(LICENSES), REPOS)
        # Seconds from EPOCH: created 2008-2019, pushed before June 2019.
        june = int((START - EPOCH).total_seconds())
        self.repo_created = randint(0, june - 86400 * 30, REPOS)
        self.repo_stars = torch.floor(torch.exp(torch.rand(
            REPOS, generator=gen, device=device) * 9) - 1).to(torch.int64)
        self.repo_size = randint(1, 200_000, REPOS)


def generate(seed: int, n_bytes: int, device) -> torch.Tensor:
    """``n_bytes`` of event JSON lines from ``seed``, as a uint8 tensor on
    ``device``."""
    world_gen = torch.Generator(device=device)
    world_gen.manual_seed(WORLD_SEED)
    w = World(world_gen, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 64) - 1))
    days = F.table([(EPOCH + datetime.timedelta(d)).date().isoformat()
                    for d in range(12 * 366 + 60)], device)
    june = int((START - EPOCH).total_seconds())
    tables = {name: F.table(values, device) for name, values in (
        ("types", TYPES), ("branches", BRANCHES), ("domains", DOMAINS),
        ("langs", ['"%s"' % x for x in LANGUAGES] + ["null"]),
        ("licenses", LICENSES), ("labels", LABELS),
        ("label_names", [x.split('"')[0].replace(" ", "%20")
                         for x in LABELS]),
        ("assoc", ASSOCIATIONS), ("bool", ("false", "true")),
        ("ref_types", ("branch", "tag", "repository")),
        ("pr_actions", ("opened", "closed", "reopened")),
        ("issue_actions", ("opened", "closed")),
        ("states", ("open", "closed")), ("ext", (".js", ".py", ".go", ".md",
                                                ".ts", ".java", ".c")))}
    clock = {"t": 0.0, "id": 9_750_000_000 + int(torch.randint(
        0, 10 ** 8, (1,), generator=gen, device=device))}
    rows = max(256, min(ROWS, n_bytes // 2048))

    def chunk(rows):
        def randint(lo, hi, n=rows):
            return torch.randint(lo, hi, (n,), generator=gen, device=device)

        def rand(n=rows):
            return torch.rand(n, generator=gen, device=device)

        def num(v, width=12):
            return F.digits(v, width)

        def stamp(secs):
            """ISO 8601 of seconds from EPOCH."""
            n = len(secs)
            return F.template("${d}T${h}:${m}:${s}Z", n, device,
                              d=F.pick(days, secs // 86400),
                              h=F.two(secs // 3600 % 24),
                              m=F.two(secs // 60 % 60), s=F.two(secs % 60))

        def text(n, lo, hi):
            ids = F.zipf_ranks(gen, VOCAB, WORD_THETA, n * hi,
                               device).reshape(n, hi)
            return F.words(w.vocab, ids, randint(lo, hi + 1, n))

        def node(prefix, ids):
            return F.base64(F.join([F.const(prefix, len(ids), device),
                                    num(ids)]))

        def user(actor):
            n = len(actor)
            i = w.actor_id[actor]
            return F.template(USER, n, device,
                              l=F.pick(w.actor_login, actor), i=num(i),
                              n=node("04:User", i), k=num(i % 4, 1))

        def repo(r, owner, fork, now):
            """Full repository objects of world repositories ``r``, owned
            by actors ``owner``; a fork (``fork``) has its own id and no
            stars, forks or issues of its own."""
            n = len(r)
            own = fork.to(torch.int64)
            rid = torch.where(fork, randint(190_000_000, 200_000_000, n),
                              w.repo_id[r])
            name = F.pick(w.repo_name, r)
            f = F.template("${o}/${name}", n, device,
                           o=F.pick(w.actor_login, owner), name=name)
            desc = F.template('"${t}"', n, device, t=F.words(
                w.vocab, w.repo_desc[r], w.repo_desc_n[r]))
            has_desc = w.repo_desc_n[r] > 0
            created = torch.where(fork, now - randint(3600, 86400 * 400, n),
                                  w.repo_created[r])
            stars = w.repo_stars[r] * (1 - own)
            return F.template(
                REPO, n, device, i=num(rid), n=node("010:Repository", rid),
                name=name, f=f, owner=user(owner),
                desc=F.either(has_desc, desc, F.const("null", n, device)),
                fork=F.pick(tables["bool"], own),
                created=stamp(created),
                updated=stamp(now - randint(0, 86400 * 30, n)),
                pushed=stamp(now - randint(0, 3600, n)),
                size=num(w.repo_size[r]), stars=num(stars),
                lang=F.pick(tables["langs"], w.repo_lang[r]),
                forks=num(stars // 7),
                issues=num(stars // 11 * (1 - own)),
                license=F.pick(tables["licenses"], w.repo_license[r]))

        gaps = -torch.log1p(-torch.rand(rows, generator=gen, device=device,
                                        dtype=torch.float64)) * MEAN_GAP_S
        t = clock["t"] + torch.cumsum(gaps, 0)
        clock["t"] = float(t[-1])
        now = june + t.to(torch.int64)
        ids = clock["id"] + torch.cumsum(randint(1, 40), 0)
        clock["id"] = int(ids[-1])
        typ = F.zipf_ranks(gen, len(TYPES), TYPE_THETA, rows, device)
        actor = F.zipf_items(gen, w.actor_perm, ACTOR_THETA, rows)
        repo_i = F.zipf_items(gen, w.repo_perm, REPO_THETA, rows)
        org = F.zipf_items(gen, w.org_perm, 1.0, rows)
        has_org = rand() < ORG_SHARE

        pieces = []
        for k, name in enumerate(TYPES):
            idx = torch.nonzero(typ == k).flatten()
            n = len(idx)
            if n == 0:
                continue
            a, r, ts = actor[idx], repo_i[idx], now[idx]
            owner = w.repo_owner[r]
            f = F.template("${o}/${name}", n, device,
                           o=F.pick(w.actor_login, owner),
                           name=F.pick(w.repo_name, r))
            login = F.pick(w.actor_login, a)
            now_s = stamp(ts)
            number = randint(1, 3000, n)
            common = dict(f=f, now=now_s, num=num(number),
                          assoc=F.pick(tables["assoc"], randint(0, 5, n)))

            def T(text, **fields):
                return F.template(text, n, device, **{**common, **fields})

            def sha():
                return F.hexstr(gen, n, 40, device)

            def pull(state_closed):
                fork = rand(n) < 0.6
                head_owner = torch.where(fork, a, owner)
                merged = state_closed & (rand(n) < 0.7)
                opened = ts - randint(60, 86400 * 20, n)
                closed = F.either(state_closed, F.template(
                    '"${s}"', n, device, s=now_s), F.const("null", n, device))
                head_sha = sha()
                pid = randint(200_000_000, 290_000_000, n)
                return T(PULL, id=num(pid),
                         n=node("011:PullRequest", pid),
                         state=F.pick(tables["states"],
                                      state_closed.to(torch.int64)),
                         title=text(n, 2, 10), user=user(a),
                         body=text(n, 0, 80), opened=stamp(opened),
                         closed=closed,
                         merged_at=F.either(merged, F.template(
                             '"${s}"', n, device, s=now_s),
                             F.const("null", n, device)),
                         merge_sha=sha(), head_sha=head_sha,
                         head_login=F.pick(w.actor_login, head_owner),
                         branch=F.pick(tables["branches"],
                                       randint(3, len(BRANCHES), n)),
                         head_user=user(head_owner),
                         head_repo=repo(r, head_owner, fork, ts),
                         base_login=F.pick(w.actor_login, owner),
                         base_sha=sha(), base_user=user(owner),
                         base_repo=repo(r, owner, torch.zeros_like(fork),
                                        ts),
                         merged=F.pick(tables["bool"],
                                       merged.to(torch.int64)),
                         merged_by=F.either(merged, user(owner),
                                            F.const("null", n, device)),
                         comments=num(randint(0, 12, n)),
                         reviews=num(randint(0, 8, n)),
                         commits=num(randint(1, 9, n)),
                         adds=num(randint(0, 900, n)),
                         dels=num(randint(0, 300, n)),
                         files=num(randint(1, 30, n)))

            def issue(is_pr):
                iid = randint(440_000_000, 460_000_000, n)
                closed = rand(n) < 0.3
                has_label = rand(n) < 0.25
                label = randint(0, len(LABELS), n)
                lid = randint(1_000_000, 1_400_000_000, n)
                labels = F.keep(F.template(
                    LABEL, n, device, f=f, id=num(lid),
                    n=node("010:Label", lid),
                    name=F.pick(tables["label_names"], label),
                    label=F.pick(tables["labels"], label)), has_label)
                return T(ISSUE, id=num(iid), n=node("05:Issue", iid),
                         title=text(n, 2, 10),
                         user=user(F.zipf_items(gen, w.actor_perm,
                                                ACTOR_THETA, n)),
                         labels=labels,
                         state=F.pick(tables["states"],
                                      closed.to(torch.int64)),
                         comments=num(randint(0, 20, n)),
                         opened=stamp(ts - randint(60, 86400 * 60, n)),
                         closed=F.either(closed, F.template(
                             '"${s}"', n, device, s=now_s),
                             F.const("null", n, device)),
                         pr=F.keep(T(ISSUE_PR), is_pr), body=text(n, 0, 80))

            def comment():
                cid = randint(497_000_000, 505_000_000, n)
                return T(COMMENT, id=num(cid),
                         n=node("012:IssueComment", cid), user=user(a),
                         body=text(n, 1, 60))

            if name == "PushEvent":
                size = 1 + F.zipf_ranks(gen, COMMITS, COMMIT_THETA, n, device)
                m = int(size.sum())
                owner_of = torch.repeat_interleave(
                    torch.arange(n, device=device), size, output_size=m)
                c_sha = F.hexstr(gen, m, 40, device)
                c_login = F.pick(w.actor_login, a[owner_of])
                commit = F.template(
                    COMMIT + ",", m, device, sha=c_sha, f=F.pick(f, owner_of),
                    email=F.template("${l}@${d}", m, device, l=c_login,
                                     d=F.pick(tables["domains"],
                                              randint(0, len(DOMAINS), m))),
                    name=c_login, message=text(m, 1, 14))
                last = torch.cumsum(size, 0) - 1
                commit = (commit[0], commit[1] - torch.zeros(
                    m, dtype=torch.int64, device=device).index_fill_(
                        0, last, 1))
                per_push = torch.zeros(n, dtype=torch.int64, device=device)
                per_push.index_add_(0, owner_of, commit[1])
                before = F.hexstr(gen, n, 40, device)
                new_branch = rand(n) < 0.05
                before = (torch.where(new_branch[:, None], 48, before[0]).to(
                    torch.uint8), before[1])
                payload = T(
                    '{"push_id":${push},"size":${size},"distinct_size":'
                    '${size},"ref":"refs/heads/${branch}","head":"${head}",'
                    '"before":"${before}","commits":[${commits}]}',
                    push=num(randint(3_600_000_000, 3_800_000_000, n)),
                    size=num(size), branch=F.pick(tables["branches"],
                                                  randint(0, len(BRANCHES),
                                                          n)),
                    head=F.pick(c_sha, last), before=before,
                    commits=F.segments(F.flatten(commit), per_push))
            elif name == "CreateEvent":
                ref_type = F.choice(gen, [0.6, 0.25, 0.15], n, device)
                ref = F.either(ref_type == 2, F.const("null", n, device),
                               F.template('"${b}"', n, device,
                                          b=F.pick(tables["branches"],
                                                   randint(0, len(BRANCHES),
                                                           n))))
                has_desc = rand(n) < 0.6
                payload = T(
                    '{"ref":${ref},"ref_type":"${rt}","master_branch":'
                    '"master","description":${desc},"pusher_type":"user"}',
                    ref=ref, rt=F.pick(tables["ref_types"], ref_type),
                    desc=F.either(has_desc, F.template(
                        '"${t}"', n, device, t=text(n, 1, 12)),
                        F.const("null", n, device)))
            elif name == "WatchEvent":
                payload = T('{"action":"started"}')
            elif name == "PullRequestEvent":
                action = F.choice(gen, [0.5, 0.45, 0.05], n, device)
                payload = T('{"action":"${action}","number":${num},'
                            '"pull_request":${pr}}',
                            action=F.pick(tables["pr_actions"], action),
                            pr=pull(action == 1))
            elif name == "IssueCommentEvent":
                payload = T('{"action":"created","issue":${issue},'
                            '"comment":${comment}}',
                            issue=issue(rand(n) < 0.35), comment=comment())
            elif name == "IssuesEvent":
                action = F.choice(gen, [0.6, 0.4], n, device)
                payload = T('{"action":"${action}","issue":${issue}}',
                            action=F.pick(tables["issue_actions"], action),
                            issue=issue(torch.zeros(n, dtype=torch.bool,
                                                    device=device)))
            elif name == "DeleteEvent":
                payload = T('{"ref":"${b}","ref_type":"branch",'
                            '"pusher_type":"user"}',
                            b=F.pick(tables["branches"],
                                     randint(3, len(BRANCHES), n)))
            elif name == "ForkEvent":
                forkee = repo(r, a, torch.ones(n, dtype=torch.bool,
                                               device=device), ts)
                # The forkee is a repository object with "public" last.
                payload = T('{"forkee":${forkee},"public":true}}',
                            forkee=(forkee[0], forkee[1] - 1))
            elif name == "PullRequestReviewCommentEvent":
                rid = randint(250_000_000, 260_000_000, n)
                cid = randint(290_000_000, 300_000_000, n)
                rc = T(REVIEW_COMMENT, id=num(cid),
                       n=node("024:PullRequestReviewComment", cid),
                       review=num(rid), line=num(randint(1, 900, n)),
                       h1=text(n, 1, 8), h2=text(n, 1, 8), h3=text(n, 1, 8),
                       path=F.template("src/${w}${e}", n, device,
                                       w=text(n, 1, 1),
                                       e=F.pick(tables["ext"],
                                                randint(0, 7, n))),
                       pos=num(randint(1, 60, n)), sha=sha(), user=user(a),
                       body=text(n, 1, 40))
                payload = T('{"action":"created","comment":${c},'
                            '"pull_request":${pr}}', c=rc,
                            pr=pull(torch.zeros(n, dtype=torch.bool,
                                                device=device)))
            elif name == "ReleaseEvent":
                rel = randint(17_000_000, 18_000_000, n)
                tag = F.template("v${a}.${b}.${c}", n, device,
                                 a=num(randint(0, 5, n), 1),
                                 b=num(randint(0, 30, n), 2),
                                 c=num(randint(0, 20, n), 2))
                payload = T('{"action":"published","release":${rel}}',
                            rel=T(RELEASE, id=num(rel),
                                  n=node("07:Release", rel), tag=tag,
                                  title=text(n, 1, 6), user=user(a),
                                  body=text(n, 0, 60)))
            elif name == "GollumEvent":
                page = text(n, 1, 3)
                payload = T('{"pages":[{"page_name":"${p}","title":"${p}",'
                            '"summary":null,"action":"edited","sha":'
                            '"${sha}","html_url":"https://github.com/${f}/'
                            'wiki/${p}"}]}', p=page, sha=sha())
            elif name == "MemberEvent":
                payload = T('{"member":${m},"action":"added"}',
                            m=user(F.zipf_items(gen, w.actor_perm,
                                                ACTOR_THETA, n)))
            elif name == "CommitCommentEvent":
                cid = randint(33_000_000, 34_000_000, n)
                payload = T('{"comment":${c}}',
                            c=T(COMMIT_COMMENT, id=num(cid),
                                n=node("013:CommitComment", cid), sha=sha(),
                                user=user(a), body=text(n, 1, 40)))
            else:  # PublicEvent
                payload = T("{}")
            o = org[idx]
            org_json = F.keep(F.template(
                ORG, n, device, i=num(w.org_id[o]),
                l=F.pick(w.org_login, o)), has_org[idx])
            aid = num(w.actor_id[a])
            record = F.join([
                T(HEAD, id=num(ids[idx]), type=F.pick(tables["types"],
                                                      typ[idx]),
                  aid=aid, login=login, rid=num(w.repo_id[r])),
                T(TAIL, payload=payload, org=org_json)])
            pieces.append((idx, record))
        return F.merge(pieces, rows, device)

    return F.generate(chunk, n_bytes, rows)
