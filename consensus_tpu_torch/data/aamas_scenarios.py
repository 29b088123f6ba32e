"""AAMAS paper scenario data (issues + participant opinions): a verbatim
copy of ``consensus_tpu/data/aamas_scenarios.py``'s data.

``SCENARIOS`` holds the five appendix survey scenarios (shared by both
model families, ``configs/appendix/{gemma,llama}/scenario_{1..5}``) and
``MAIN_BODY`` the paper's three main-body scenarios
(``configs/main_body/scenario_{1,2,3}.yaml``).  The paper's welfare numbers
are measured on this exact text; the scenario registry's ``aamas:<k>`` and
``main_body:<k>`` refs resolve here.
"""

# Appendix scenarios 1-5: shared by both model families.
SCENARIOS = {1: {'agent_opinions': {'Agent 1': "I'd like to think it should be considered private "
                                   'information and for the persons privacy to be '
                                   'respected. However, it may be important for '
                                   'research or for the biological family. If the '
                                   'person is open for it, then their opinion should '
                                   'be respected',
                        'Agent 2': 'A persons genetic code should be considered '
                                   'private information for the sole reason it belongs '
                                   'to them. I can only think of medical case use '
                                   'scenarios when it may be useful to someone else in '
                                   'the case of faulty genes etc being eradicated by '
                                   "using someone else's stem cells or dna to help in "
                                   'this.',
                        'Agent 3': 'The majority of all the genetic code is identical '
                                   'between people. I am undecided on the matter, the '
                                   'differences make us different. But by sharing all '
                                   'the genetic code, this may help prevent and cure '
                                   'illnesses so I would be slightly in favour if used '
                                   'appropriately.',
                        'Agent 4': "I believe that a person's genetic code should be "
                                   'considered private information, the same way you '
                                   "wouldn't give out your address or personal "
                                   'information to strangers, it should cover your '
                                   'genetic makeup as well as it could be used to '
                                   'screen out people with specific genetic markers '
                                   'and for discrimination in the future. Having '
                                   'access to your genetic information also has the '
                                   'added risk of being potentially harmful to any '
                                   'offspring in the future and I believe that '
                                   'precaution should be taken to ensure that your '
                                   'genetic code is safe from abuse by others.'},
     'issue': "Should a person's genetic code be considered private information?"},
 2: {'agent_opinions': {'Agent 1': 'Yes taxes should be increased in order to fund a '
                                   'more comprehensive benefits system because this is '
                                   'the best means to create a safe, secure and '
                                   'productive society in the long term. Especially in '
                                   'recent times, with the ongoing challenges '
                                   'countries across the world are facing, it would be '
                                   'tantamount to negligence to either keep benefits '
                                   'in their current form or reduce them.  '
                                   'Comprehensive benefits systems that will protect '
                                   'people in all kinds of situations are one of the '
                                   'hallmarks of a successful country which shows that '
                                   'it cares actively for its citizens and that '
                                   'everyone is invested in that care.',
                        'Agent 2': 'I think we need a better benefits system than the '
                                   'one we already have.  I think it needs a complete '
                                   'overhaul, it is difficult for those that are most '
                                   'vulnerable and at risk to access the support they '
                                   'need, and what is available is just not '
                                   'sufficient.  Take carers for example, they have to '
                                   'take care of someone for a minimum of 35 hours per '
                                   'week, but only receive the equivalent of £1.99 to '
                                   'pay for this from the Government. Increasing taxes '
                                   'would allow reform and to support people like '
                                   'carers better.',
                        'Agent 3': 'I believe the benefits system is inadequate, '
                                   'recent studies by JRF and similar show this. I '
                                   'thus think it should be more comprehensive as '
                                   'there are anomolies between the help available '
                                   'through different benefits such as income and '
                                   'contribution based.  Rates should be increased '
                                   'across the board. Some tax rises to fund this '
                                   'would be justified, but there is no point adding '
                                   'to the tax burden of those on the lowest incomes '
                                   'who may be in receipt of top up benefit as it is '
                                   'taking away what is already given, so I would '
                                   'propose taxing the well off more instead.',
                        'Agent 4': 'I think it is a good idea as we could improve the '
                                   'wellfare of many people. I think the rich should '
                                   'also be taxed more to help other people. I like '
                                   'the idea of everyone having better access to the '
                                   'things they need such as medical care. Some things '
                                   'are to expensive for people on lower incomes to '
                                   'afford.',
                        'Agent 5': 'I believe that the tax system should be revised, '
                                   'meaning that the highest earners in this country '
                                   'will pay a larger amount of tax. I also believe '
                                   'that the level of tax that corporations pay should '
                                   'be increased. In the last decade, the gap between '
                                   'the lowest and highest earners has only been '
                                   'increasing. On top of this, vicious cuts to '
                                   'benefits and services have hit the least well off '
                                   'in society very hard.'},
     'issue': 'Should we increase taxes to fund a more comprehensive benefits system?'},
 3: {'agent_opinions': {'Agent 1': 'No we should not.  As long as adults are behaving '
                                   'responsibly it is for the to decide if they '
                                   'partake in alcohol or cigarettes.  Banning the '
                                   'sale of these would fundamentally change the '
                                   'hospitality industry and cause is the closure of '
                                   'businesses and loss of jobs for many people.',
                        'Agent 2': 'No we should not. More careful measures should be '
                                   'used to target those who engage in them in an '
                                   'antil social manner.',
                        'Agent 3': 'No. Even though I personally would love to see '
                                   "this (as a sober, non-smoker) I don't believe it "
                                   'would work in practice and I believe it would just '
                                   'drive the sale of alcohol and cigarettes '
                                   'underground. We can see this from looking at the '
                                   'prohibition era of America, even though alcohol '
                                   'was effectively banned, it just led to illegal '
                                   'saloons opening up where people would drink '
                                   'anyway. I think banning these things would lead to '
                                   'an increase in crime and the funding of criminal '
                                   'enterprises and organised crime.',
                        'Agent 4': "I don't know to be honest. Cigarettes, yes, "
                                   'because they can cause all sorts of damage. But '
                                   "alcohol, I enjoy drinking and it's fun. But if we "
                                   'start to ban everything then we become at risk of '
                                   'becoming a nanny state. People should take more '
                                   'care for themselves and learn their own boundries.',
                        'Agent 5': "I don't think that alcohol and cigarettes should "
                                   'be banned in public places but of course both '
                                   'should only be sold to people who are of the legal '
                                   'age and ID should also be retrieved. Drinking and '
                                   'smoking can be something that is fun if done '
                                   'responsibly so I dont see why it should be '
                                   'banned.'},
     'issue': 'Should we ban the sale of alcohol and cigarettes in public places?'},
 4: {'agent_opinions': {'Agent 1': 'It is important that children feel happy, safe and '
                                   'comfortable in school, so we should take into '
                                   'account their views. However it is also important '
                                   'to ensure every child gets a well-rounded and '
                                   'complete education. This means they should not '
                                   'have the option to drop out before they have '
                                   'reached a level of qualification that will stand '
                                   'them in good stead for their future life. Young '
                                   'people may not have the perspective to understand '
                                   'the importance of this for their futures.',
                        'Agent 2': 'Their views are important because it affects them '
                                   "directly, and it's also important to engage "
                                   'children and ensure that they are actively '
                                   'learning rather than exposing them to content they '
                                   'find completely uninteresting and therefore fail '
                                   'to engage with. However, there are certain topics '
                                   'that may be boring to children but are extremely '
                                   'important for them to learn for their future, such '
                                   "as maths and science, so it's arguably more "
                                   'important to provide adequate support to their '
                                   'learning so they can find enjoyment in their '
                                   'learning regardless. Of course, adults have a '
                                   'better view in terms of what would benefit a child '
                                   '- as a child may choose things they enjoy '
                                   'short-term but that may not benefit them in the '
                                   'long term - so they should dictate what children '
                                   'learn up to a certain age. Regardless, children '
                                   'should be notified about the content of their '
                                   'learning, and feedback should be taken from them '
                                   'to ensure they are benefitting in the long run.',
                        'Agent 3': "yes i do believe that children's views on their "
                                   'education are very important. Children are '
                                   'ultimately those in receipt of the education and '
                                   'will respond appropriately as to whether they deem '
                                   'it functional.',
                        'Agent 4': 'Children have a right to have a say in their '
                                   'education. However, the age of the child should be '
                                   'taken into account. The education system is proven '
                                   'to work well but all learning styles are different '
                                   'and not every teaching method suits every child.',
                        'Agent 5': "Yes as at the end of the day it's their future.  "
                                   'If they are being taught things that are not '
                                   "relevant to modern day life it's pointless.  They "
                                   'should be heard'},
     'issue': "Are children's views about their education important?"},
 5: {'agent_opinions': {'Agent 1': 'The EU is becoming increasingly bloated and '
                                   'ineffective. Due to its size there appears to be '
                                   'more of an emphasis on corporatism and big '
                                   'business to the detriment of individual countries '
                                   'cultural identities. These are the sort of '
                                   'traditions and way of life that foster meaning and '
                                   'a sense of community. With larger organisations '
                                   'this individual flavour is lost to the detrimental '
                                   'of an individual and a collective of any size',
                        'Agent 2': 'Because of the incompetent and unwilling handling '
                                   'of Brexit, it seems clear we would currently be '
                                   'better off inside Europe. Our trade, both import '
                                   'and export, has been damaged badly with no sign of '
                                   'a satisfactory resolution. Additionally the '
                                   'administration for individuals and business for '
                                   'travel and residence have become a deep negative. '
                                   'The mood of the nation is also very divided '
                                   'although I am unsure whether that can be '
                                   'overcomeby a return to EU membership.',
                        'Agent 3': 'Uk was better off inside the Europen union, the '
                                   'reason is that if we compare advantages and '
                                   'disadvantages then we notice that we are wosre off '
                                   'after leaving Europen union. Food prices are going '
                                   'higher and it is not good socially. Not good for '
                                   'economy,',
                        'Agent 4': 'i feel that there is strenght in number, that the '
                                   'uk has been and remains so closely connected to '
                                   'euroipe both geographically and politically that '
                                   'being within it would be better. As a small island '
                                   'our resources are limited. The older generation '
                                   'may want the good old times but they really no '
                                   'longer exist and progress must be made. '
                                   'Geographical borders no longer limit us, we have '
                                   'better transport, education, we are more mobile, '
                                   'multilingual. We should be more focused on '
                                   'humanity and the health and wealth of the world as '
                                   'a whole. Connecting the world into bigger groups '
                                   'will bring better cohesion and perhaps reduce '
                                   'risks of conflict. shared resources, reduced '
                                   'costs. Young people wish to travel, to widen their '
                                   'horizons',
                        'Agent 5': 'The UK is most definitely better off within the EU '
                                   'and has seen many negatives since leaving and very '
                                   'few positives. The interconnected nature of '
                                   'European economies means there is much to be '
                                   'gained from formal ties of the EU - moving from '
                                   'having a number of countries on their own not '
                                   'being particularly powerful or influential on the '
                                   'world stage, to a significant international power '
                                   'when coming together as one. Being in the EU '
                                   'generally means improved economic outcomes, more '
                                   'jobs, more investment, higher wages etc, and is '
                                   'very much a beneficial thing.'},
     'issue': 'Is the UK better off inside or outside of the European Union?'}}

# Main-body scenarios 1-3, incl. the reference's `predefined` control
# statement (the cross-backend A/B anchor, SURVEY section 7.3).
MAIN_BODY = {1: {'methods_to_run': ['best_of_n',
                        'finite_lookahead',
                        'habermas_machine',
                        'predefined',
                        'beam_search'],
     'predefined_statement': "Although in the past we've had high hopes of a better "
                             'world after the horrors of WWII and the fall of the Iron '
                             'Curtain, democracy is in danger worldwide and may never '
                             'reach its full potential. The Western world has poor '
                             'democratic values, and even though democracy is '
                             'spreading worldwide it is being overshadowed by the loud '
                             'voices of minority groups.',
     'scenario': {'agent_opinions': {'Agent 1': 'No, I think the golden age of '
                                                'democracy is long gone. I think a '
                                                'system where the first past the post '
                                                'wins is not working and we need to '
                                                'move to a model of proportional '
                                                'representation which would give more '
                                                'people the feeling that their voices '
                                                'were being heard. On the subject of '
                                                "voices, I'm strongly of the opinion "
                                                'that we have beome a society where '
                                                'the loud voices of minority groups '
                                                'are able to impose their views on the '
                                                'rest of the population which to me is '
                                                'no democracy at all.',
                                     'Agent 2': 'Worldwide democracy is more present '
                                                "than it's ever been in history. So "
                                                'yes, compared to previous ages in '
                                                'history I believe we are. Although '
                                                "that's not to say we can't improve - "
                                                "many countries still don't operate "
                                                'democratically, and in the ones that '
                                                'do, corruption is rife.',
                                     'Agent 3': 'Yes, we are living in a golden age of '
                                                'democracy as democracy is of the '
                                                'people.',
                                     'Agent 4': 'Not at all. The notion of democracy '
                                                'is being used for personal gains of '
                                                'those in government, and the system '
                                                'is manipulated. Around the world '
                                                'there is a considerable amount of '
                                                'oppression and lack of democractic '
                                                'values.',
                                     'Agent 5': 'Comapred to some parts of the world '
                                                'such as Russia and China which are '
                                                'actively regressing and reverting '
                                                'back to archaic ways of controlling '
                                                'their people, most Western countries '
                                                'are living through comparitively '
                                                'decent times, although problems still '
                                                'exist.'},
                  'issue': 'Are we living in a golden age of democracy?'}},
 2: {'methods_to_run': ['best_of_n',
                        'finite_lookahead',
                        'habermas_machine',
                        'predefined',
                        'beam_search'],
     'predefined_statement': "The UK's ties to Europe should be stronger. This is "
                             'because, although the UK did leave the EU, we are '
                             'geographically and economically in proximity to most EU '
                             'countries. Several geographic, financial, political and '
                             'economical parameters are intertwined with our '
                             'neighbouring countries and, it would be advantageous to '
                             'be in good relations to fully harness our economic, '
                             'political, and financial facilities.',
     'scenario': {'agent_opinions': {'Agent 1': 'When we was in Europe we had good '
                                                'trade with them , The decision to '
                                                'leave was very bad for united kindom '
                                                '. We need to put the vote again to '
                                                'the British public i am sure this '
                                                'time the decision would be to remain',
                                     'Agent 2': 'The natural evolution of our species '
                                                'has been to grow into ever bigger '
                                                '"tribes". Families ruled by their '
                                                'patriarchs became tribes ruled by '
                                                'elders became countries ruled by '
                                                'governments. It made sense that '
                                                'countries would evolve separately '
                                                'since they were geographically '
                                                'separate with no means of '
                                                'communication. Now our world is so '
                                                'connected, it is inevitable that we '
                                                'evolve into ever larger units such as '
                                                'the United States and the European '
                                                'Union. Eventually we will become a '
                                                'multi-planetary species ruled by an '
                                                'Earth government. To sever ties with '
                                                'Europe is a step in the wrong '
                                                'direction.',
                                     'Agent 3': 'Although we did exit EU few years '
                                                'ago, we are geographically and '
                                                'economically in proximity to most EU '
                                                'countries. Several geographic, '
                                                'financial, political and economical '
                                                'parameters are intertwined with our '
                                                'neighbouring countries and, it would '
                                                'be advantageous to be in good '
                                                'relations to fully harness our '
                                                'economic, political, and financial '
                                                'facilities.',
                                     'Agent 4': "I believe the UK's ties to Europe "
                                                'should be stronger, as it would make '
                                                'trade deals easier to negotiate. This '
                                                'would allow us to benefit from a '
                                                'larger array of goods, which would '
                                                'make our imports cheaper. I also '
                                                'believe that closer ties with Europe '
                                                'in terms of immigration policies '
                                                'should occur as our immigration '
                                                "policy doesn't coincide with other "
                                                'nations around us. I believe a more '
                                                'united Europe would help all '
                                                'countries grow more through the '
                                                'movement of free labour, goods and '
                                                'services and more.',
                                     'Agent 5': 'I think they should be stronger, as '
                                                'all the countries of Europe, except '
                                                'us, are part of the EU, and it makes '
                                                'Britain more isolated. Countries are '
                                                'stronger I believe when they work '
                                                'together with other countries and are '
                                                'open to the influence of other '
                                                'countries. I believe that leaving the '
                                                'EU was a step backwards and done for '
                                                'the wrong reasons. We are not the '
                                                'country we were 100 or even 50 years '
                                                'ago and the world is changing so much '
                                                'that we cannot afford to not be part '
                                                'of Europe.'},
                  'issue': "Should the UK's ties to Europe be stronger or weaker?"}},
 3: {'methods_to_run': ['best_of_n',
                        'finite_lookahead',
                        'habermas_machine',
                        'predefined',
                        'beam_search'],
     'predefined_statement': 'Humans have used animals for food since we first evolved '
                             'as a species. Animals provide a great deal of nutrition '
                             'that the human body needs to be healthy. It is certainly '
                             'true that we now have more alternative foods available '
                             'so that it can be possible to live healthily without '
                             'consuming meat - though this does usually rely on taking '
                             'nutritional supplements. We should continue to diversify '
                             'food production to provide people with meat '
                             'alternatives, but also we should continue to improve the '
                             'welfare of animals that are eaten for food and try to do '
                             'this sustainably to minimise the impact this has on the '
                             'animals wellbeing and on the land / environment too.',
     'scenario': {'agent_opinions': {'Agent 1': 'Yes, as human beings are natural meat '
                                                'eaters. However, it is morally wrong '
                                                'to keep animals in cruel conditions '
                                                'and use them for food. On the whole, '
                                                'farming is an unethical practise and '
                                                'many farming methods should be '
                                                'banned.',
                                     'Agent 2': 'I think that it is ok to use animals '
                                                'for food because I enjoy eating meat. '
                                                "I don't think it is ok if the animal "
                                                'is endangered and I do think that '
                                                'there should be certain factors in '
                                                'place to ensure that they are well '
                                                'kept.',
                                     'Agent 3': 'In my opinion it is ok to use animals '
                                                'for food. They provide nutrition and '
                                                'vitamins to use and I think it is '
                                                'just the basic food chain. I do '
                                                'understand why people choose to be '
                                                'vegatarian or vegan, but I do not '
                                                'agree with them trying to force their '
                                                'views upon others.',
                                     'Agent 4': 'Humans have used animals for food '
                                                'since we first evolved as a species. '
                                                'Animals provide a great deal of '
                                                'nutrition that the human body needs '
                                                'to be healthy. It is certainly true '
                                                'that we now have more alternative '
                                                'foods available so that it can be '
                                                'possible to live healthily without '
                                                'consuming meat - though this does '
                                                'usually rely on taking nutritional '
                                                'supplements. I think that we should '
                                                'continue to diversify food production '
                                                'to provide people with meat '
                                                'alternatives, but also we should '
                                                'continue to improve the welfare of '
                                                'animals that are eaten for food and '
                                                'try to do this sustainably to '
                                                'minimise the impact this has on the '
                                                'animals wellbeing and on the land / '
                                                'environment too.'},
                  'issue': 'Is it okay to use animals for food?'}}}
